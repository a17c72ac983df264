"""The eval (serving) step (port of `efg_tpu/engine/trainer.py` eval_fn).

The JAX trainer jits `module.apply(train=False)` followed by `predict_fn`;
here the module runs eagerly in eval mode under `torch.inference_mode`.
The trainer loop itself comes with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from efg_tpu_torch.engine.train_state import ModelDef


@torch.inference_mode()
def eval_step(model_def: ModelDef, batch: Dict[str, Any]):
    """One serving step: forward in eval mode (running BN statistics), then
    `predict_fn` when the model has one. Puts the module in eval mode."""
    model_def.module.eval()
    preds = model_def.module(**model_def.apply_args(batch))
    if model_def.predict_fn is None:
        return preds
    return model_def.predict_fn(preds, batch)
