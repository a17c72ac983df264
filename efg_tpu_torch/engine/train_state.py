"""Training state and model definition protocol (port of
`efg_tpu/engine/train_state.py`).

efg_tpu threads an immutable pytree (step, params, batch_stats,
opt_state) through its jitted step. Here the module holds the parameters
and the BN running statistics, and the step updates both in place.
`custom_loss` and the EMA hooks of the JAX container come with the models
that use them (ConQueR).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int  # updates applied so far
    module: nn.Module  # parameters and BN buffers
    opt_state: Any


class ModelDef:
    """module      — torch nn.Module; called `module(**apply_args(batch))`
    apply_args  — batch → kwargs for the module call (tensors only)
    loss_fn     — (preds, batch) → dict with key "loss" (+ metrics)
    predict_fn  — (preds, batch) → per-sample fixed-shape detections
    """

    def __init__(
        self,
        module: nn.Module,
        apply_args: Callable[[Dict[str, Any]], Dict[str, Any]],
        loss_fn: Optional[Callable] = None,
        predict_fn: Optional[Callable] = None,
    ):
        self.module = module
        self.apply_args = apply_args
        self.loss_fn = loss_fn
        self.predict_fn = predict_fn
