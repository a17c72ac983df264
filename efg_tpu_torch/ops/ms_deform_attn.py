"""Multi-scale deformable attention sampling (port of
`efg_tpu/ops/ms_deform_attn.py`).

Per (query, head, level, point): bilinear sampling of the head's channel
slice of the level's value map at a normalized location (taps outside
the map contribute zero), weighted by the softmaxed attention weights
and summed. Built on `box_attention._bilinear_gather`, as efg_tpu's on
its `_bilinear_gather`; where efg_tpu gathers one point at a time, a
level's P points go through one call (folded into the query axis), so a
layer runs 3 levels × 4 taps of gathers, not 48. Plain PyTorch: efg_tpu
reaches no Pallas kernel here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from efg_tpu_torch.ops.box_attention import _bilinear_gather


def ms_deform_attn_sample(value_levels: Sequence[torch.Tensor], sampling_locations: torch.Tensor,
                          attn_weights: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """value_levels: [B, H_l, W_l, C] maps (C = num_heads · head_dim);
    sampling_locations [B, L, NH, NL, P, 2] normalized (x, y);
    attn_weights [B, L, NH, NL, P] softmaxed over NL·P → [B, L, C]."""
    b, l, nh, _, p, _ = sampling_locations.shape
    c = value_levels[0].shape[-1]
    out = value_levels[0].new_zeros(b, l, nh, c // num_heads)
    for lvl, vmap in enumerate(value_levels):
        h, w = vmap.shape[1:3]
        flat = vmap.reshape(b, h * w, c)
        loc = sampling_locations[:, :, :, lvl].permute(0, 1, 3, 2, 4).reshape(b, l * p, nh, 2)
        sampled = _bilinear_gather(flat, loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5, h, w)
        wgt = attn_weights[:, :, :, lvl].permute(0, 1, 3, 2)[..., None].to(out.dtype)
        out = out + (sampled.reshape(b, l, p, nh, -1) * wgt).sum(dim=2)
    return out.reshape(b, l, c)
