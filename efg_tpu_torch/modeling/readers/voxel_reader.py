"""Point-cloud readers (port of `efg_tpu/modeling/readers/voxel_reader.py`):
the dynamic mean VFE that feeds the sparse voxel trunk, and the dynamic
PointPillars encoder with its scatter onto the BEV canvas."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.modeling.common.norms import MaskedBatchNorm
from efg_tpu_torch.ops import voxelize as V


def dynamic_mean_vfe(
    points: torch.Tensor,
    mask: torch.Tensor,
    *,
    pc_range: Tuple[float, ...],
    voxel_size: Tuple[float, ...],
    max_voxels: int,
    num_input_features: int,
):
    """points [B, N, C], mask [B, N] → (features [B, V, F], coords_zyx
    [B, V, 3], valid [B, V]). Feature = mean of the first
    `num_input_features` point channels over the voxel. The JAX `vmap`
    over samples is a loop here: each sample is one sort of N ids."""
    feats, coords, valid = [], [], []
    for p, m in zip(points, mask):
        vox = V.voxelize(p, m, pc_range=pc_range, voxel_size=voxel_size, max_voxels=max_voxels)
        feats.append(V.voxel_mean(p[:, :num_input_features], vox.point_slot, vox.counts, max_voxels))
        coords.append(vox.coords)
        valid.append(vox.valid)
    return torch.stack(feats), torch.stack(coords), torch.stack(valid)


class PillarFeatureNet(nn.Module):
    """Dynamic PointPillars encoder (efg_tpu's `PillarFeatureNet`): every
    point is decorated with its raw features, its offset from its pillar's
    mean and its offset from its pillar's centre, runs through the PFN
    layers (Linear without bias, MaskedBatchNorm, ReLU), and is max-pooled
    into its pillar. The Linear weights start as flax's Dense (truncated
    normal, variance 1/fan_in), drawn from `generator`."""

    def __init__(self, num_filters: Sequence[int] = (64,), num_input_features: int = 5,
                 pc_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
                 voxel_size: Tuple[float, ...] = (0.2, 0.2, 6.0), max_pillars: int = 30000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.num_input_features = num_input_features
        self.pc_range, self.voxel_size = tuple(pc_range), tuple(voxel_size)
        self.max_pillars = max_pillars
        cin = num_input_features + 5
        for i, nf in enumerate(self.num_filters):
            lin = nn.Linear(cin, nf, bias=False)
            std = math.sqrt(1.0 / cin) / 0.87962566103423978  # flax's truncation correction
            with torch.no_grad():
                nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            setattr(self, f"pfn{i}_dense", lin)
            setattr(self, f"pfn{i}_bn", MaskedBatchNorm(nf))
            cin = nf

    def forward(self, points: torch.Tensor, mask: torch.Tensor):
        """points [B, N, C], mask [B, N] → (pillar_feats [B, P, F],
        coords_yx [B, P, 2], valid [B, P])."""
        vs, pr, cap = self.voxel_size, self.pc_range, self.max_pillars
        voxels = [V.voxelize(p, m, pc_range=pr, voxel_size=vs, max_voxels=cap)
                  for p, m in zip(points, mask)]
        slot = torch.stack([v.point_slot for v in voxels])  # [B, N]
        coords = torch.stack([v.coords for v in voxels])  # [B, P, 3] (z, y, x)
        valid = torch.stack([v.valid for v in voxels])
        means = torch.stack([V.voxel_mean(p[:, :3], v.point_slot, v.counts, cap)
                             for p, v in zip(points, voxels)])  # [B, P, 3]

        ok = slot >= 0
        slot_c = torch.where(ok, slot, 0).long()
        mean_per_point = torch.gather(means, 1, slot_c[..., None].expand(-1, -1, 3))
        cx = (coords[..., 2].to(points.dtype) + 0.5) * vs[0] + pr[0]
        cy = (coords[..., 1].to(points.dtype) + 0.5) * vs[1] + pr[1]
        centers = torch.stack([cx, cy], dim=-1)  # [B, P, 2]
        center_per_point = torch.gather(centers, 1, slot_c[..., None].expand(-1, -1, 2))

        feats = torch.cat([points[..., :self.num_input_features],
                           points[..., :3] - mean_per_point,
                           points[..., :2] - center_per_point], dim=-1)
        feats = feats * ok[..., None].to(feats.dtype)
        b, n, c = feats.shape
        flat, flat_ok = feats.reshape(b * n, c), ok.reshape(b * n)
        for i in range(len(self.num_filters)):
            flat = getattr(self, f"pfn{i}_dense")(flat)
            flat = torch.relu(getattr(self, f"pfn{i}_bn")(flat, flat_ok))
        feats = flat.reshape(b, n, -1)
        pillar_feats = torch.stack([V.voxel_max(f, s, cap) for f, s in zip(feats, slot)])
        return pillar_feats, coords[..., 1:], valid


def pillar_scatter(pillar_feats: torch.Tensor, coords_yx: torch.Tensor, valid: torch.Tensor, *,
                   ny: int, nx: int) -> torch.Tensor:
    """Scatter pillars onto the dense BEV canvas [B, ny, nx, F]; empty
    cells and invalid pillars give 0."""
    b, _, f = pillar_feats.shape
    flat_idx = coords_yx[..., 0].long() * nx + coords_yx[..., 1].long()
    flat_idx = torch.where(valid, flat_idx, ny * nx)
    vals = pillar_feats * valid[..., None].to(pillar_feats.dtype)
    canvases = []
    for feats, idx in zip(vals, flat_idx):
        canvas = feats.new_zeros(ny * nx + 1, f).index_put((idx,), feats)
        canvases.append(canvas[:ny * nx].reshape(ny, nx, f))
    return torch.stack(canvases)
