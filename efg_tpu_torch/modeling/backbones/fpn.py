"""Feature Pyramid Network and the sine position encoding (port of
`efg_tpu/modeling/backbones/fpn.py`).

NHWC at the module boundary like efg_tpu; inside, the maps are NCHW views
(the port's Conv2d / BatchNorm layout). Lateral 1×1 convs, the top-down
path with an exact 2× nearest upsample (`jax.image.resize(..., "nearest")`
at twice the size repeats every cell), 3×3 output convs, and the
LastLevelMaxPool top block p(max+1). Convs and norms in f32, as flax's
default dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.modeling.common.norms import BatchNorm


def _stage_of(res_name: str) -> int:
    """res2 → p2, res3 → p3, res4 → p4 (efg_tpu's `_stage_of`)."""
    return int(res_name[-1])


class FPN(nn.Module):
    """efg_tpu's FPN as Voxel-DETR builds it (norm "BN", sum fusion, the
    top block). `in_channels` maps each input feature (high → low
    resolution order) to its channel count."""

    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = tuple(in_channels)
        for f, c in in_channels.items():
            setattr(self, f"lateral_{f}", Conv2d(c, out_channels, 1, dtype=None,
                                                 generator=generator))
            setattr(self, f"output_{f}", Conv2d(out_channels, out_channels, 3, padding=1,
                                                dtype=None, generator=generator))
            setattr(self, f"lateral_{f}_norm", BatchNorm(out_channels))
            setattr(self, f"output_{f}_norm", BatchNorm(out_channels))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_norm")(getattr(self, name)(x))

    def forward(self, features: Dict[str, torch.Tensor],
                levels: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        """features {res_k: [B, H, W, C]} → {p_k: [B, H, W, out]}. With
        `levels`, only those p-levels are computed, and the top-down path
        only as far down as they reach (efg_tpu's jit drops what nothing
        reads)."""
        last = max(_stage_of(f) for f in self.in_features)
        top = f"p{last + 1}"
        if levels is None:
            levels = [f"p{_stage_of(f)}" for f in self.in_features] + [top]
        made = set(levels) | ({f"p{last}"} if top in levels else set())
        lowest = min(int(p[1:]) for p in made)
        results, prev = {}, None
        for f in reversed(self.in_features):  # low resolution first
            if _stage_of(f) < lowest:
                break
            lat = self._conv(f"lateral_{f}", features[f].permute(0, 3, 1, 2))
            if prev is None:
                prev = lat
            else:
                prev = lat + F.interpolate(prev, scale_factor=2, mode="nearest")
            if f"p{_stage_of(f)}" in made:
                results[f"p{_stage_of(f)}"] = self._conv(f"output_{f}", prev)
        if top in levels:  # LastLevelMaxPool: a 1×1 window at stride 2
            results[top] = results[f"p{last}"][:, :, ::2, ::2]
        return {k: results[k].permute(0, 2, 3, 1) for k in levels}


def position_embedding_sine(x: torch.Tensor, num_pos_feats: int = 128,
                            temperature: float = 10000.0, normalize: bool = True) -> torch.Tensor:
    """Sine 2D position encoding of an NHWC map's grid (efg_tpu's
    `PositionEmbeddingSine`): [B, H, W, 2·num_pos_feats] in x's dtype,
    y features first, sin / cos interleaved."""
    b, h, w, _ = x.shape
    dev = x.device
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    if normalize:
        eps, scale = 1e-6, 2 * math.pi
        y_embed = (y_embed - 0.5) / (y_embed[-1:, :] + eps) * scale
        x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=dev)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos = torch.cat([pos_y, pos_x], dim=-1)
    return pos[None].expand(b, h, w, pos.shape[-1]).to(x.dtype)
