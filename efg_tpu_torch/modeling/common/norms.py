"""Normalization layers (port of `efg_tpu/modeling/common/norms.py`).

`MaskedBatchNorm` normalizes sparse voxel rows [N, C] with statistics over
the valid rows only. `BatchNorm` is the dense NCHW counterpart of
`flax.linen.BatchNorm` as the RPN and CenterHead use it, with flax's
arithmetic: y = (x − mean)·(rsqrt(var + eps)·scale) + bias in f32.

Under data parallelism (`parallel/ddp.py`) both take their statistics over
the global batch, as efg_tpu's do over its sharded batch: the sums, the
sums of squares and the counts of every rank in one differentiable
all-reduce. In a world of one the arithmetic is the one-process one.

Both keep flax's momentum convention (running = m·running + (1−m)·batch,
m = 0.9 ≡ torch momentum 0.1) and name their state like torch's BatchNorm
(weight, bias, running_mean, running_var) for the weight mapper.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from efg_tpu_torch.parallel import ddp


class _Norm(nn.Module):
    def __init__(self, num_features: int, momentum: float, eps: float):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(m).add_((1 - m) * mean)
        self.running_var.mul_(m).add_((1 - m) * var)


class MaskedBatchNorm(_Norm):
    """BatchNorm over rows [N, C] with a validity mask [N]; padding rows
    come out as 0. `dtype` is the output (activation-storage) dtype; None
    keeps the input's."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, momentum, eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(torch.float32)[:, None]
            xf = x.to(torch.float32)
            # one pass: E[x²]−E[x]², fine in f32 at BN-scale magnitudes
            xm = xf * m
            c = xf.shape[1]
            # [Σx, Σx², count] over the ranks (itself in a world of one)
            s = ddp.all_reduce_sum(torch.cat([xm.sum(dim=0), (xm * xf).sum(dim=0),
                                              m.sum().reshape(1)]))
            cnt = torch.clamp(s[2 * c], min=1.0)
            mean = s[:c] / cnt
            var = torch.clamp(s[c:2 * c] / cnt - mean * mean, min=0.0)
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.to(torch.float32) - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        y = y * self.weight + self.bias
        y = y * mask.to(y.dtype)[:, None]
        return y.to(self.out_dtype or x.dtype)


class BatchNorm(_Norm):
    """Dense BatchNorm over NCHW maps, computed in f32 (flax promotes a
    bf16 input against its f32 parameters), output f32."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(num_features, momentum, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            if ddp.active():
                c = x.shape[1]
                n = x.new_full((1,), x.numel() // c)
                s = ddp.all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                                  (x * x).sum(dim=(0, 2, 3)), n]))
                mean = s[:c] / s[2 * c]
                var = torch.clamp(s[c:2 * c] / s[2 * c] - mean * mean, min=0.0)
            else:
                mean = x.mean(dim=(0, 2, 3))
                var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
