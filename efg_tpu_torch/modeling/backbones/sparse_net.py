"""The SpMiddleResNetFHD sparse voxel trunk (port of
`efg_tpu/modeling/backbones/sparse_net.py`).

Same topology and parameter names as the flax modules: SubM stem →
residual stages → strided downsamples → z-compressing extra conv → BEV
reshape, with one packed rulebook per stage shared by its SubM layers.
The BEV map is NHWC [B, H, W, C·D].
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.modeling.common.norms import MaskedBatchNorm
from efg_tpu_torch.ops import sparse as sp


def _sparse_weight(k: int, cin: int, cout: int,
                   generator: Optional[torch.Generator] = None) -> nn.Parameter:
    """[K, Cin, Cout] kernel, initialised like flax's
    variance_scaling(1/3, fan_in, uniform): U(±1/sqrt(K·Cin)), drawn from
    `generator` (None: torch's global RNG)."""
    bound = 1.0 / math.sqrt(k * cin)
    return nn.Parameter(torch.empty(k, cin, cout).uniform_(-bound, bound, generator=generator))


class SubMConv(nn.Module):
    """Submanifold sparse conv layer (weight [27, Cin, Cout])."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _sparse_weight(27, in_channels, features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, st: sp.SparseTensor, rulebook: torch.Tensor) -> sp.SparseTensor:
        return sp.subm_conv(st, self.weight, rulebook, bias=self.bias)


class SparseConvDown(nn.Module):
    """Strided (generative) sparse conv layer."""

    def __init__(self, in_channels: int, features: int, *, max_out: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 stride: Tuple[int, int, int] = (2, 2, 2),
                 padding: Tuple[int, int, int] = (1, 1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.max_out = max_out  # per-sample output capacity
        self.weight = _sparse_weight(math.prod(kernel_size), in_channels, features, generator)

    def forward(self, st: sp.SparseTensor) -> sp.SparseTensor:
        return sp.spconv_downsample(
            st, self.weight, kernel_size=self.kernel_size, stride=self.stride,
            padding=self.padding, max_out=self.max_out * st.batch_size,
        )


class _BNReLU(nn.Module):
    """MaskedBatchNorm (flax path `<name>/bn`), then ReLU unless `relu` is
    False."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None, relu: bool = True):
        super().__init__()
        self.bn = MaskedBatchNorm(features, dtype=dtype)
        self.relu = relu

    def forward(self, st: sp.SparseTensor) -> sp.SparseTensor:
        f = self.bn(st.features, st.valid)
        return st.replace_features(torch.relu(f) if self.relu else f)


class SparseBasicBlock(nn.Module):
    """Two SubM convs + BN + residual (bias on the convs)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = SubMConv(features, features, use_bias=True, generator=generator)
        self.bn1 = _BNReLU(features, dtype)
        self.conv2 = SubMConv(features, features, use_bias=True, generator=generator)
        self.bn2 = MaskedBatchNorm(features, dtype=dtype)

    def forward(self, st: sp.SparseTensor, rulebook: torch.Tensor) -> sp.SparseTensor:
        identity = st.features
        out = self.conv1(st, rulebook)
        out = self.bn1(out)
        out = self.conv2(out, rulebook)
        f = self.bn2(out.features, out.valid)
        f = torch.relu(f + identity.to(f.dtype))
        return out.replace_features(f * out.valid[:, None].to(f.dtype))


class SpMiddleResNetFHD(nn.Module):
    """The CenterPoint voxel trunk. `grid_size` is the (nx, ny, nz) voxel
    grid; the sparse D dim is nz+1. `stage_caps` are the per-sample voxel
    capacities after each of the 4 downsamples (multiplied by the batch
    size inside). `act_dtype` "bfloat16" stores the inter-layer activations
    in bf16 (BN statistics stay f32); "" keeps f32. The conv weights are
    drawn from `generator` (None: torch's global RNG)."""

    def __init__(self, num_input_features: int = 5,
                 grid_size: Tuple[int, int, int] = (1504, 1504, 40),
                 stage_caps: Sequence[int] = (60000, 40000, 20000, 16000),
                 act_dtype: str = "", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.act_dtype = getattr(torch, act_dtype) if act_dtype else None
        act = self.act_dtype
        caps = tuple(stage_caps)
        self.conv_input = SubMConv(num_input_features, 16, generator=generator)
        self.bn_input = _BNReLU(16, act)
        self.res0a = SparseBasicBlock(16, act, generator)
        self.res0b = SparseBasicBlock(16, act, generator)
        self.down1 = SparseConvDown(16, 32, max_out=caps[0], generator=generator)
        self.bn_down1 = _BNReLU(32, act)
        self.res1a = SparseBasicBlock(32, act, generator)
        self.res1b = SparseBasicBlock(32, act, generator)
        self.down2 = SparseConvDown(32, 64, max_out=caps[1], generator=generator)
        self.bn_down2 = _BNReLU(64, act)
        self.res2a = SparseBasicBlock(64, act, generator)
        self.res2b = SparseBasicBlock(64, act, generator)
        self.down3 = SparseConvDown(64, 128, max_out=caps[2], padding=(0, 1, 1),
                                    generator=generator)
        self.bn_down3 = _BNReLU(128, act)
        self.res3a = SparseBasicBlock(128, act, generator)
        self.res3b = SparseBasicBlock(128, act, generator)
        self.extra_conv = SparseConvDown(
            128, 128, max_out=caps[3], kernel_size=(3, 1, 1), stride=(2, 1, 1),
            padding=(0, 0, 0), generator=generator,
        )
        self.bn_extra = _BNReLU(128, act)

    @property
    def spatial_shape(self) -> Tuple[int, int, int]:
        nx, ny, nz = self.grid_size
        return (nz + 1, ny, nx)

    @property
    def num_bev_channels(self) -> int:
        """C·D of the BEV map: 128 channels times the final z extent."""
        shape = self.spatial_shape
        for down in (self.down1, self.down2, self.down3, self.extra_conv):
            shape = sp._downsample_shape(shape, down.kernel_size, down.stride, down.padding)
        return 128 * shape[0]

    def forward(self, features, coords_zyx, valid) -> torch.Tensor:
        """features [B, V, C], coords_zyx [B, V, 3] (z, y, x), valid [B, V]
        → BEV [B, ny/8, nx/8, 128·D]."""
        st = sp.from_batched_voxels(features, coords_zyx, valid, self.spatial_shape)
        if self.act_dtype is not None:
            st = st.replace_features(st.features.to(self.act_dtype))

        rb = sp.build_rulebook(st)
        st = self.bn_input(self.conv_input(st, rb))
        st = self.res0b(self.res0a(st, rb), rb)

        for down, bn, ra, rb_block in (
            (self.down1, self.bn_down1, self.res1a, self.res1b),
            (self.down2, self.bn_down2, self.res2a, self.res2b),
            (self.down3, self.bn_down3, self.res3a, self.res3b),
        ):
            st = bn(down(st))
            rb = sp.build_rulebook(st)
            st = rb_block(ra(st, rb), rb)

        st = self.bn_extra(self.extra_conv(st))
        return sp.bev_dense(st)
