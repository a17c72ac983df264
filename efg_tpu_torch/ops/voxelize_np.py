"""Host (numpy) hard voxelizer: a copy of `efg_tpu/ops/voxelize_np.py`,
numpy path only (efg_tpu's native C++ `points_to_voxel` is not ported).

Voxels are indexed in order of first point appearance, each voxel stores
at most `max_points` points in arrival order, at most `max_voxels` voxels
are kept, and coords are reversed (z, y, x). Used by the `Voxelization`
processor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def points_to_voxel(
    points: np.ndarray,
    voxel_size: Sequence[float],
    pc_range: Sequence[float],
    max_points: int = 35,
    max_voxels: int = 20000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (voxels [V', max_points, C], coords [V', 3] as (z, y, x),
    num_points_per_voxel [V'])."""
    voxel_size = np.asarray(voxel_size, dtype=points.dtype)
    pc_range = np.asarray(pc_range, dtype=points.dtype)
    grid = np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int32)

    cf = np.floor((points[:, :3] - pc_range[:3]) / voxel_size)
    valid = ((cf >= 0) & (cf < grid)).all(axis=1)
    pts = points[valid]
    c = cf[valid].astype(np.int64)
    lin = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]

    # first-appearance voxel ordering
    _, first_idx, inverse = np.unique(lin, return_index=True, return_inverse=True)
    order_of_voxel = np.argsort(np.argsort(first_idx))  # rank by first appearance
    vox_of_point = order_of_voxel[inverse]
    num_unique = first_idx.shape[0]
    num_voxels = min(num_unique, max_voxels)

    # arrival rank of each point within its voxel
    perm = np.argsort(vox_of_point, kind="stable")
    sorted_vox = vox_of_point[perm]
    boundaries = np.concatenate([[0], np.flatnonzero(np.diff(sorted_vox)) + 1])
    starts = np.zeros(len(sorted_vox), dtype=np.int64)
    starts[boundaries] = boundaries
    starts = np.maximum.accumulate(starts)
    rank_sorted = np.arange(len(sorted_vox)) - starts
    rank = np.empty_like(rank_sorted)
    rank[perm] = rank_sorted

    keep = (vox_of_point < num_voxels) & (rank < max_points)
    voxels = np.zeros((num_voxels, max_points, points.shape[1]), dtype=points.dtype)
    voxels[vox_of_point[keep], rank[keep]] = pts[keep]

    coords = np.zeros((num_voxels, 3), dtype=np.int32)
    first_pt_of_voxel = np.zeros(num_unique, dtype=np.int64)
    first_pt_of_voxel[order_of_voxel[inverse[first_idx]]] = first_idx
    cz = c[first_pt_of_voxel[:num_voxels]]
    coords[:, 0] = cz[:, 2]
    coords[:, 1] = cz[:, 1]
    coords[:, 2] = cz[:, 0]

    num_points_per_voxel = np.bincount(
        vox_of_point[keep], minlength=num_voxels
    ).astype(np.int32)[:num_voxels]
    return voxels, coords, num_points_per_voxel


class VoxelGenerator:
    """Config-carrying wrapper (reference: `efg/data/utils/voxel_generator.py:6-44`)."""

    def __init__(self, voxel_size, point_cloud_range, max_num_points, max_voxels=20000):
        self.voxel_size = np.asarray(voxel_size, dtype=np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels
        self.grid_size = np.round(
            (self.point_cloud_range[3:] - self.point_cloud_range[:3]) / self.voxel_size
        ).astype(np.int64)

    def generate(self, points: np.ndarray, max_voxels: int | None = None):
        return points_to_voxel(
            points,
            self.voxel_size,
            self.point_cloud_range,
            self.max_num_points,
            max_voxels or self.max_voxels,
        )
