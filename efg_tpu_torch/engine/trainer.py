"""The train and eval steps (port of `step_fn` and `eval_fn` of
`efg_tpu/engine/trainer.py`).

efg_tpu jits both; here they run eagerly. The trainer loop, hooks and
checkpointing come with the engine slice.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from efg_tpu_torch.engine.train_state import ModelDef, TrainState
from efg_tpu_torch.solver.optimizers import global_norm


def init_state(model_def: ModelDef, tx) -> TrainState:
    return TrainState(step=0, module=model_def.module,
                      opt_state=tx.init(list(model_def.module.parameters())))


def train_forward(model_def: ModelDef, state: TrainState, batch: Dict[str, Any]):
    """Forward in train mode (batch statistics; the BN running stats update
    as a side effect), with the parameters' grads cleared first."""
    module = state.module
    module.train()
    for p in module.parameters():
        p.grad = None
    return module(**model_def.apply_args(batch))


def apply_grads(tx, state: TrainState) -> torch.Tensor:
    """`tx` (clip + AdamW) on the grads the backward left, in place; a
    parameter without a grad counts as a zero grad. Returns the global norm
    before clipping."""
    params: List[torch.Tensor] = list(state.module.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    grad_norm = global_norm(grads)
    tx.step(params, grads, state.opt_state, grad_norm=grad_norm)
    state.step += 1
    return grad_norm


def train_step(model_def: ModelDef, tx, state: TrainState,
               batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One training step: `train_forward`, losses, backward, `apply_grads`.
    Returns the detached losses plus `grad_norm`, the global norm before
    clipping. Leaves the module in train mode and this step's grads on the
    parameters."""
    preds = train_forward(model_def, state, batch)
    losses = model_def.loss_fn(preds, batch)
    losses["loss"].backward()
    grad_norm = apply_grads(tx, state)
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = grad_norm
    return metrics


@torch.inference_mode()
def eval_step(model_def: ModelDef, batch: Dict[str, Any]):
    """One serving step: forward in eval mode (running BN statistics), then
    `predict_fn` when the model has one. Puts the module in eval mode."""
    model_def.module.eval()
    preds = model_def.module(**model_def.apply_args(batch))
    if model_def.predict_fn is None:
        return preds
    return model_def.predict_fn(preds, batch)
