"""Flax-compatible layers shared by the port's transformer models.

`dense` is an nn.Linear initialised as flax's `Dense` with a named kernel
init; `MultiHeadDotProductAttention` is flax's attention module written
out as its query / key / value / out projections (the weight mapper,
`utils/jax_import.py`, folds flax's head axes into them). Voxel-DETR,
ConQueR, TrajectoryFormer and Mask2Former build on them.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

# flax's LayerNorm and GroupNorm epsilon (torch's default is 1e-5)
FLAX_NORM_EPS = 1e-6


def dense(cin: int, cout: int, *, kernel: str = "lecun", bias: Any = 0.0,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear initialised as flax's Dense with the named kernel init
    ("lecun": truncated normal, variance 1/fan_in; "xavier"; "zeros") and a
    constant bias, or bias "uniform": U(0, 1)."""
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        if kernel == "lecun":
            std = math.sqrt(1.0 / cin) / 0.87962566103423978  # flax's truncation correction
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        elif kernel == "xavier":
            nn.init.xavier_uniform_(lin.weight, generator=generator)
        else:
            lin.weight.zero_()
        if bias == "uniform":
            lin.bias.uniform_(0.0, 1.0, generator=generator)
        else:
            lin.bias.fill_(float(bias))
    return lin


class MultiHeadDotProductAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` (qkv_features = out_features =
    d_model): query / key / value projections split into NH heads, the
    query scaled by 1/√hd, softmax over keys where `mask` is True (masked
    logits set to the dtype's minimum, as flax), then the `out`
    projection. Each projection is a Linear [NH·hd, C] here; the weight
    mapper reshapes flax's [C, NH, hd] and [NH, hd, C] kernels."""

    def __init__(self, d_model: int, num_heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, dense(d_model, d_model, generator=generator))

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        b, lq, c = q.shape
        nh, hd = self.num_heads, c // self.num_heads

        def heads(x, proj):
            return proj(x).reshape(b, x.shape[1], nh, hd).transpose(1, 2)  # [B, NH, L, hd]

        qh = heads(q, self.query) / math.sqrt(hd)
        kh, vh = heads(k, self.key), heads(v, self.value)
        logits = qh @ kh.transpose(-1, -2)  # [B, NH, Lq, Lk]
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, dim=-1) @ vh
        return self.out(out.transpose(1, 2).reshape(b, lq, c))
