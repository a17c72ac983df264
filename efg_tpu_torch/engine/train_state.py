"""Model definition protocol (port of `efg_tpu/engine/train_state.py`).

`ModelDef` is what an experiment's `build_model(config)` returns. The
training-only fields of the JAX container (custom_loss, EMA hooks,
init_params) and `TrainState` come with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from torch import nn


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
