"""ConQueR serving (port of the forward side of `efg_tpu/models/conquer.py`).

`ConQueRModule` holds the Voxel-DETR trunk and the contrastive projector
and predictor, with efg_tpu's parameter names (`detr`, `projector`,
`predictor`), so a flax ConQueR tree maps onto it leaf for leaf. Serving
runs the trunk and `predict`; the projector and predictor serve only the
training loss. Training (contrastive denoising queries, the EMA momentum
decoder, the matcher and the losses) is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.models import voxel_detr as VD

TRAINING_ITEM = 8  # ROADMAP queue 1: ConQueR training


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to efg_tpu_torch yet (ROADMAP queue 1 item {TRAINING_ITEM})")


class _ProjMLP(nn.Module):
    """Linear-ReLU-Linear projector / predictor."""

    def __init__(self, cin: int, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = VD.dense(cin, dim, generator=generator)
        self.fc1 = VD.dense(dim, dim, generator=generator)

    def forward(self, x):
        return self.fc1(torch.relu(self.fc0(x)))


class ConQueRModule(nn.Module):
    """The DETR trunk plus the contrastive projector / predictor."""

    def __init__(self, detr: VD.VoxelDETR, contras_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.detr = detr
        device = next(detr.parameters()).device
        self.projector = _ProjMLP(detr.num_classes + 7, contras_dim, generator).to(device)
        self.predictor = _ProjMLP(contras_dim, contras_dim, generator).to(device)

    def forward(self, points, points_mask, dn_ref=None, dn_attn_mask=None) -> Dict[str, Any]:
        return self.detr(points, points_mask, dn_ref=dn_ref, dn_attn_mask=dn_attn_mask)


def make_model_def(detr_kwargs: Dict[str, Any], model_cfg: Dict[str, Any], *,
                   device="cuda", generator: Optional[torch.Generator] = None) -> ModelDef:
    """The ConQueR ModelDef for serving: module, apply_args and predict_fn.
    Its loss is training's and raises "not ported"."""
    detr = VD.VoxelDETR(**detr_kwargs, device=device, generator=generator)
    module = ConQueRModule(detr, contras_dim=int(model_cfg["contrastive"].get("dim", 256)),
                           generator=generator)

    def apply_args(batch):
        return dict(points=batch["points"], points_mask=batch["points_mask"])

    def loss_fn(preds, batch):
        raise _not_ported("ConQueR training (custom loss, EMA momentum decoder)")

    def predict_fn(preds, batch):
        return VD.predict(preds, model_cfg=model_cfg)

    return ModelDef(module, apply_args, loss_fn, predict_fn)
