"""Point-cloud readers (port of `efg_tpu/modeling/readers/voxel_reader.py`):
the dynamic mean VFE that feeds the sparse voxel trunk."""

from __future__ import annotations

from typing import Tuple

import torch

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
