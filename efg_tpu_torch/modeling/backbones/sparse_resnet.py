"""Sparse ResNet family → multi-scale BEV maps (port of
`efg_tpu/modeling/backbones/sparse_resnet.py`).

Strided stem and residual stages on the port's sparse convs, with the
flax modules' parameter names; each requested `out_feature` passes a
z-compressing (3,1,1)/(2,1,1) conv and densifies to an NHWC BEV map
[B, H, W, C·D] (channel c·D + d). Widths double per stage from
`res1_out_channels`, so ResNet-18's res4 runs its convs at 256 channels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.sparse_net import (
    SparseBasicBlock,
    SparseConvDown,
    SubMConv,
    _BNReLU,
)
from efg_tpu_torch.ops import sparse as sp

# depth → blocks per stage (reference `num_blocks_per_stage`)
_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
_STEM_WIDTH = {18: 16, 34: 16}
_OUT_MULTIPLIER = (6, 3, 2)  # z-planes after the per-output compress conv


class _ResStage(nn.Module):
    """One res stage: strided first block whose projection is its own
    shortcut, then SubM residual blocks sharing one rulebook. `max_out` is
    the per-sample capacity of the stage's sites."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int, max_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down = SparseConvDown(in_channels, out_channels, max_out=max_out,
                                   generator=generator)
        self.down_bn = _BNReLU(out_channels, relu=False)
        self.b0_conv2 = SubMConv(out_channels, out_channels, generator=generator)
        self.b0_bn2 = _BNReLU(out_channels, relu=False)
        for i in range(1, num_blocks):
            setattr(self, f"b{i}", SparseBasicBlock(out_channels, generator=generator))
        self.num_blocks = num_blocks

    def forward(self, st: sp.SparseTensor) -> sp.SparseTensor:
        out = self.down_bn(self.down(st))
        rb = sp.build_rulebook(out)
        x = self.b0_bn2(self.b0_conv2(out, rb))
        f = torch.relu(x.features + out.features) * x.valid[:, None].to(x.features.dtype)
        x = x.replace_features(f)
        for i in range(1, self.num_blocks):
            x = getattr(self, f"b{i}")(x, rb)
        return x


class SparseResNet(nn.Module):
    """Reference `SparseResNet` producing BEV maps. `grid_size` is the
    (nx, ny, nz) voxel grid (sparse D = nz + 1); `stage_caps` are the
    per-sample capacities [after the stem's stride 2, res2, res3, res4,
    res5], multiplied by the batch size inside."""

    def __init__(self, depth: int = 18, num_input_features: int = 5,
                 stem_out_channels: int = 32, res1_out_channels: int = 64,
                 out_features: Sequence[str] = ("res2", "res3", "res4"),
                 grid_size: Tuple[int, int, int] = (1504, 1504, 40),
                 stage_caps: Sequence[int] = (60000, 40000, 25000, 15000, 10000),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth not in _BLOCKS:
            raise ValueError(f"SparseResNet depth {depth}: expected one of {sorted(_BLOCKS)}")
        self.grid_size = tuple(grid_size)
        self.out_features = tuple(out_features)
        self.res1_out_channels = res1_out_channels
        stem_w = _STEM_WIDTH[depth]
        caps = tuple(stage_caps)
        self.stem_down = SparseConvDown(num_input_features, stem_w, max_out=caps[0],
                                        generator=generator)
        self.stem_bn0 = _BNReLU(stem_w)
        self.stem_conv1 = SubMConv(stem_w, stem_w, generator=generator)
        self.stem_bn1 = _BNReLU(stem_w)
        self.stem_conv2 = SubMConv(stem_w, stem_out_channels, generator=generator)
        self.stem_bn2 = _BNReLU(stem_out_channels)

        max_stage = max(int(f[-1]) for f in self.out_features)
        self.stages = [f"res{s}" for s in range(2, max_stage + 1)]
        cin, widths = stem_out_channels, {}
        for i, name in enumerate(self.stages):
            widths[name] = res1_out_channels * 2 ** i
            setattr(self, name, _ResStage(cin, widths[name], _BLOCKS[depth][i], caps[1 + i],
                                          generator=generator))
            cin = widths[name]
        for name in sorted(self.out_features):
            c = widths[name]
            # its capacity is its stage's (efg_tpu: `max_out=s.capacity`)
            setattr(self, f"{name}_out", SparseConvDown(
                c, c, kernel_size=(3, 1, 1), stride=(2, 1, 1), padding=(1, 0, 0),
                max_out=caps[1 + self.stages.index(name)], generator=generator))
            setattr(self, f"{name}_out_bn", _BNReLU(c))

    @property
    def spatial_shape(self) -> Tuple[int, int, int]:
        nx, ny, nz = self.grid_size
        return (nz + 1, ny, nx)

    def output_channels(self) -> Dict[str, int]:
        """C·D of each BEV map (efg_tpu's `output_channels`)."""
        out = {}
        for k, f in enumerate(sorted(self.out_features)):
            out[f] = self.res1_out_channels * 2 ** (int(f[-1]) - 2) * _OUT_MULTIPLIER[k]
        return out

    def forward(self, features, coords_zyx, valid) -> Dict[str, torch.Tensor]:
        """features [B, V, C], coords_zyx [B, V, 3] (z, y, x), valid [B, V]
        → {res_k: BEV [B, H_k, W_k, C_k·D_k]}."""
        st = sp.from_batched_voxels(features, coords_zyx, valid, self.spatial_shape)
        st = self.stem_bn0(self.stem_down(st))
        rb = sp.build_rulebook(st)
        st = self.stem_bn1(self.stem_conv1(st, rb))
        st = self.stem_bn2(self.stem_conv2(st, rb))
        outputs = {}
        for name in self.stages:
            st = getattr(self, name)(st)
            if name in self.out_features:
                outputs[name] = st
        bev = {}
        for name, s in sorted(outputs.items()):
            o = getattr(self, f"{name}_out_bn")(getattr(self, f"{name}_out")(s))
            bev[name] = sp.bev_dense(o)
        return bev
