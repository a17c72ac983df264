"""2D ResNet trunk (port of `efg_tpu/modeling/backbones/resnet.py`).

NCHW maps; convs in f32 (flax's default dtype), without bias, drawn from
msra (variance_scaling(2, fan_out, truncated_normal)) as efg_tpu's. The
stem is a 7×7 stride-2 conv, a norm, ReLU and a 3×3 stride-2 max pool
that pads with −inf; res2..res5 are bottleneck stages (depth 50/101) or
basic stages (18/34). `freeze_at` cuts the gradient at the stem (≥ 1) and
after each stage up to res{freeze_at}, as efg_tpu's `stop_gradient`.

Frozen BN is efg_tpu's `FrozenBatchNorm`: its `scale` and `bias` are flax
params, so they train (the weight decay mask leaves them out); only the
statistics are fixed. Here they are `nn.Parameter`s and the statistics
buffers, named like torch's BatchNorm for the weight mappers. This
differs from detectron2's `FrozenBatchNorm2d`, whose affine tensors are
buffers.

Deformable conv2 (`deform_on_per_stage`) is not ported (ROADMAP queue 1
item 13).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.modeling.common.norms import BatchNorm

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon (torch's default is 1e-5)
BLOCKS_PER_STAGE = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def msra_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax variance_scaling(2.0, "fan_out", "truncated_normal") of an OIHW
    kernel, in place: N(0, σ) cut at ±2σ, σ = √(2 / (O·kh·kw)) / .8796."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def msra_conv(cin: int, cout: int, kernel: int, *, stride: int = 1, padding: int = 0,
              dilation: int = 1, bias: bool = False,
              generator: Optional[torch.Generator] = None) -> Conv2d:
    """An f32 Conv2d with efg_tpu's `_msra` kernel init (bias zeros)."""
    conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation,
                  bias=bias, dtype=None, generator=generator)
    msra_(conv.weight, generator)
    return conv


class FrozenBatchNorm(nn.Module):
    """y = x·inv + (bias − mean·inv), inv = rsqrt(var + eps)·scale, with
    fixed statistics. `weight` / `bias` are trainable parameters (efg_tpu's
    params), `running_mean` / `running_var` buffers (its batch_stats)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def make_norm(kind: str, channels: int) -> nn.Module:
    """efg_tpu's `_norm`: FrozenBN, BN / SyncBN (flax BatchNorm, momentum
    0.9; statistics over the global batch under data parallelism) or GN
    (32 groups)."""
    if kind == "FrozenBN":
        return FrozenBatchNorm(channels)
    if kind in ("BN", "SyncBN"):
        return BatchNorm(channels)
    if kind == "GN":
        return nn.GroupNorm(32, channels, eps=GN_EPS)
    raise KeyError(kind)


class _Block(nn.Module):
    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut is None:
            return x
        return self.shortcut_norm(self.shortcut(x))


class BottleneckBlock(_Block):
    def __init__(self, cin: int, out_channels: int, bottleneck_channels: int, stride: int = 1,
                 dilation: int = 1, norm: str = "FrozenBN",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.shortcut = None
        if cin != out_channels or stride != 1:
            self.shortcut = msra_conv(cin, out_channels, 1, stride=stride, generator=g)
            self.shortcut_norm = make_norm(norm, out_channels)
        self.conv1 = msra_conv(cin, bottleneck_channels, 1, generator=g)
        self.norm1 = make_norm(norm, bottleneck_channels)
        self.conv2 = msra_conv(bottleneck_channels, bottleneck_channels, 3, stride=stride,
                               padding=dilation, dilation=dilation, generator=g)
        self.norm2 = make_norm(norm, bottleneck_channels)
        self.conv3 = msra_conv(bottleneck_channels, out_channels, 1, generator=g)
        self.norm3 = make_norm(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm1(self.conv1(x)))
        out = torch.relu(self.norm2(self.conv2(out)))
        out = self.norm3(self.conv3(out))
        return torch.relu(out + self._shortcut(x))


class BasicBlock(_Block):
    """Two 3×3 convs (ResNet-18/34)."""

    def __init__(self, cin: int, out_channels: int, stride: int = 1, norm: str = "FrozenBN",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.shortcut = None
        if cin != out_channels or stride != 1:
            self.shortcut = msra_conv(cin, out_channels, 1, stride=stride, generator=g)
            self.shortcut_norm = make_norm(norm, out_channels)
        self.conv1 = msra_conv(cin, out_channels, 3, stride=stride, padding=1, generator=g)
        self.norm1 = make_norm(norm, out_channels)
        self.conv2 = msra_conv(out_channels, out_channels, 3, padding=1, generator=g)
        self.norm2 = make_norm(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        return torch.relu(out + self._shortcut(x))


class ResNet(nn.Module):
    """ResNet-18/34/50/101 on NCHW images [B, 3, H, W] → {res_k: NCHW map}
    for `out_features`. 18/34 stages are 64..512 channels wide, 50/101
    256..2048."""

    def __init__(self, depth: int = 50, norm: str = "FrozenBN",
                 out_features: Sequence[str] = ("res3", "res4", "res5"), freeze_at: int = 2,
                 res5_dilation: int = 1,
                 deform_on_per_stage: Sequence[bool] = (False, False, False, False),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if any(deform_on_per_stage):
            raise NotImplementedError(
                "ResNet.deform_on_per_stage (deformable conv2) is not ported to efg_tpu_torch "
                "yet (ROADMAP queue 1 item 13)")
        self.out_features = tuple(out_features)
        self.freeze_at = freeze_at
        self.basic = depth in (18, 34)
        self.stem_conv1 = msra_conv(3, 64, 7, stride=2, padding=3, generator=generator)
        self.stem_norm = make_norm(norm, 64)
        self.stages = []
        cin = 64
        out_ch, bott = (64, 64) if self.basic else (256, 64)
        for stage_i, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            name = f"res{stage_i + 2}"
            first_stride = 1 if stage_i == 0 else 2
            dilation = res5_dilation if name == "res5" else 1
            if dilation > 1:
                first_stride = 1
            if self.basic and dilation != 1:
                raise ValueError("BasicBlock (depth 18/34) supports no dilation")
            blocks = []
            for b in range(n_blocks):
                stride = first_stride if b == 0 else 1
                if self.basic:
                    block = BasicBlock(cin, out_ch, stride, norm, generator)
                else:
                    block = BottleneckBlock(cin, out_ch, bott, stride, dilation, norm, generator)
                setattr(self, f"{name}_block{b}", block)
                blocks.append(f"{name}_block{b}")
                cin = out_ch
            self.stages.append((name, blocks))
            out_ch *= 2
            bott *= 2
        self.out_channels = {name: (64 if self.basic else 256) * 2 ** i
                             for i, (name, _) in enumerate(self.stages)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.stem_norm(self.stem_conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if self.freeze_at >= 1:
            x = x.detach()
        outputs: Dict[str, torch.Tensor] = {}
        for stage_i, (name, blocks) in enumerate(self.stages):
            for b in blocks:
                x = getattr(self, b)(x)
            if self.freeze_at >= stage_i + 2:
                x = x.detach()
            if name in self.out_features:
                outputs[name] = x
        return outputs
