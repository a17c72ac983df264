"""Training state and model definition protocol (port of
`efg_tpu/engine/train_state.py`).

efg_tpu threads an immutable pytree (step, params, batch_stats,
opt_state) through its jitted step. Here the module holds the parameters
and the BN running statistics, and the step updates both in place. A
model with an EMA copy of some of its weights (ConQueR's momentum decoder)
keeps it in `TrainState.ema`, outside `module.parameters()`, so the
optimizer and the weight import never see it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int  # updates applied so far
    module: nn.Module  # parameters and BN buffers
    opt_state: Any
    ema: Optional[Dict[str, torch.Tensor]] = None  # ModelDef.ema_init's tensors


class ModelDef:
    """module      — torch nn.Module; called `module(**apply_args(batch))`
    apply_args  — batch → kwargs for the module call (tensors only)
    loss_fn     — (preds, batch) → dict with key "loss" (+ metrics)
    predict_fn  — (preds, batch) → per-sample fixed-shape detections
    custom_loss — optional (module, ema, batch, generator) → (loss, losses):
                  the whole training forward and loss, for models whose
                  step is more than module → loss_fn (ConQueR); `generator`
                  is the step's torch.Generator
    ema_init    — optional module → {name: tensor}, the EMA state's copies
    ema_update  — optional (ema, module) → None: updates ema in place from
                  the module's new parameters, after the optimizer step
    init_params — optional module → None: changes the initial weights in
                  place once the module is built (TrajectoryFormer's graft
                  of a pretrained motion encoder); the trainer calls it
                  where efg_tpu's calls its own, not on a resumed run
    """

    def __init__(
        self,
        module: nn.Module,
        apply_args: Callable[[Dict[str, Any]], Dict[str, Any]],
        loss_fn: Optional[Callable] = None,
        predict_fn: Optional[Callable] = None,
        custom_loss: Optional[Callable] = None,
        ema_init: Optional[Callable] = None,
        ema_update: Optional[Callable] = None,
        init_params: Optional[Callable] = None,
    ):
        self.module = module
        self.apply_args = apply_args
        self.loss_fn = loss_fn
        self.predict_fn = predict_fn
        self.custom_loss = custom_loss
        self.ema_init = ema_init
        self.ema_update = ema_update
        self.init_params = init_params
