"""Configurable BEV RPN neck (port of `efg_tpu/modeling/backbones/rpn.py`).

NHWC at the module boundary like efg_tpu; inside, the maps are NCHW views
of the same channels-last memory. Convs compute in bf16 (f32 parameters
cast per call, as flax `dtype=bfloat16` does), BatchNorm in f32. The
dense convs and transposed convs are library calls: they are plain XLA
convs in efg_tpu, not Pallas kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efg_tpu_torch.modeling.common.norms import BatchNorm


class Conv2d(nn.Module):
    """Conv holding f32 weight [O, I, kh, kw] (torch layout) and computing
    in `dtype` (None: f32). Padding is symmetric like flax's integer
    padding. Init matches flax's variance_scaling(1/3, fan_in, uniform),
    drawn from `generator` (None: torch's global RNG)."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = False,
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(cin * kernel * kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel)
                                   .uniform_(-bound, bound, generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation, self.dtype = stride, padding, dilation, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding, self.dilation)


class ConvTranspose2d(nn.Module):
    """Stride-s, kernel-s, VALID transposed conv computing in `dtype` (None:
    f32); weight in torch's [I, O, kh, kw] layout (the weight mapper flips
    flax's kernel)."""

    def __init__(self, cin: int, cout: int, stride: int, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(cin * stride * stride)
        self.weight = nn.Parameter(torch.empty(cin, cout, stride, stride)
                                   .uniform_(-bound, bound, generator=generator))
        self.stride, self.dtype = stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), stride=self.stride)


class _ConvBNReLU(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 3, stride=stride, padding=1, generator=generator)
        self.BatchNorm_0 = BatchNorm(features, bn_momentum, bn_eps)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class RPN(nn.Module):
    def __init__(self, in_channels: int,
                 layer_nums: Sequence[int] = (5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2),
                 ds_num_filters: Sequence[int] = (128, 256),
                 us_layer_strides: Sequence[int] = (1, 2),
                 us_num_filters: Sequence[int] = (256, 256),
                 bn_momentum: float = 0.9, bn_eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not len(layer_nums) == len(ds_layer_strides) == len(ds_num_filters):
            raise ValueError("layer_nums, ds_layer_strides and ds_num_filters differ in length")
        self.layer_nums = tuple(layer_nums)
        self.upsample_start = len(layer_nums) - len(us_layer_strides)
        self.num_channels = sum(us_num_filters)
        bn_kw = dict(bn_momentum=bn_momentum, bn_eps=bn_eps, generator=generator)
        cin = in_channels
        for i, n_layers in enumerate(layer_nums):
            nf = ds_num_filters[i]
            setattr(self, f"block{i}_in", _ConvBNReLU(cin, nf, ds_layer_strides[i], **bn_kw))
            for j in range(n_layers):
                setattr(self, f"block{i}_conv{j}", _ConvBNReLU(nf, nf, **bn_kw))
            cin = nf
            ui = i - self.upsample_start
            if ui >= 0:
                stride = us_layer_strides[ui]
                uf = us_num_filters[ui]
                if stride > 1:
                    setattr(self, f"deblock{ui}_deconv", ConvTranspose2d(nf, uf, stride,
                                                                       generator=generator))
                else:
                    s = int(round(1 / stride))
                    setattr(self, f"deblock{ui}_conv", Conv2d(nf, uf, s, stride=s,
                                                                generator=generator))
                setattr(self, f"deblock{ui}_bn", BatchNorm(uf, bn_momentum, bn_eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] → [B, H', W', Σ us_num_filters]."""
        x = x.permute(0, 3, 1, 2)
        ups = []
        for i, n_layers in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_in")(x)
            for j in range(n_layers):
                x = getattr(self, f"block{i}_conv{j}")(x)
            ui = i - self.upsample_start
            if ui >= 0:
                up = getattr(self, f"deblock{ui}_deconv", None) or getattr(self, f"deblock{ui}_conv")
                ups.append(torch.relu(getattr(self, f"deblock{ui}_bn")(up(x))))
        out = torch.cat(ups, dim=1) if ups else x
        return out.permute(0, 2, 3, 1)


class RPNFixBNMom(RPN):
    """efg_tpu's `RPNFixBNMom`: the RPN with BN eps 1e-3 and momentum 0.99
    (torch momentum 0.01) unless given."""

    def __init__(self, in_channels: int, bn_momentum: float = 0.99, bn_eps: float = 1e-3, **kw):
        super().__init__(in_channels, bn_momentum=bn_momentum, bn_eps=bn_eps, **kw)
