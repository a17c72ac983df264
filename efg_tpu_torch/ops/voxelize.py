"""On-device dynamic voxelization (port of `efg_tpu/ops/voxelize.py`).

One stable sort of per-point linear voxel ids gives contiguous voxel
segments; a cumsum of segment starts assigns each point a voxel slot in
`[0, max_voxels)` (first-come truncation in id order). Voxels come out
ordered by linear id, z-major: `(z·ny + y)·nx + x`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

SENTINEL = torch.iinfo(torch.int32).max


class VoxelizedPoints(NamedTuple):
    """Fixed-shape voxelization result for ONE sample.

    point_slot: [N] int32 — voxel slot per point, -1 for dropped points
    coords:     [V, 3] int32 — (z, y, x) per voxel slot, 0 where invalid
    valid:      [V] bool — slot occupancy
    counts:     [V] int32 — points per voxel (0 where invalid)
    num_voxels: [] int32 — number of occupied slots
    """

    point_slot: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor
    counts: torch.Tensor
    num_voxels: torch.Tensor


def grid_size(pc_range: Sequence[float], voxel_size: Sequence[float]) -> Tuple[int, int, int]:
    """Static (nx, ny, nz) grid shape."""
    return tuple(
        int(round((pc_range[i + 3] - pc_range[i]) / voxel_size[i])) for i in range(3)
    )


def voxelize(
    points: torch.Tensor,
    mask: torch.Tensor,
    *,
    pc_range: Tuple[float, ...],
    voxel_size: Tuple[float, ...],
    max_voxels: int,
) -> VoxelizedPoints:
    """Assign each valid point a voxel slot. `points` [N, C] (xyz first),
    `mask` [N] bool."""
    n = points.shape[0]
    dev = points.device
    nx, ny, nz = grid_size(pc_range, voxel_size)
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=dev)
    inv_vs = torch.reciprocal(torch.tensor(voxel_size, dtype=points.dtype, device=dev))

    # XLA folds efg_tpu's division by the constant voxel size into a product
    # with its reciprocal; doing the same keeps every cell id identical
    cf = torch.floor((points[:, :3] - lo) * inv_vs)
    hi = torch.tensor([nx, ny, nz], dtype=cf.dtype, device=dev)
    in_grid = ((cf >= 0) & (cf < hi)).all(dim=-1)
    valid_pt = mask & in_grid
    # cast only in-grid cells: a far-out point's float cell could overflow int32
    c = torch.where(valid_pt[:, None], cf, 0).to(torch.int32)
    lin = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    lin = torch.where(valid_pt, lin, SENTINEL)

    sorted_lin, sorted_order = torch.sort(lin, stable=True)

    first = torch.cat([sorted_lin[:1] != SENTINEL, sorted_lin[1:] != sorted_lin[:-1]])
    # never start a segment inside the sentinel run
    first = first & (sorted_lin != SENTINEL)
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    slot_sorted = torch.where(
        (sorted_lin != SENTINEL) & (seg >= 0) & (seg < max_voxels), seg, -1
    )
    point_slot = torch.empty(n, dtype=torch.int32, device=dev)
    point_slot[sorted_order] = slot_sorted

    # voxel linear ids: first occurrence writes its segment slot
    write_slot = torch.where(first & (seg < max_voxels), seg, max_voxels).long()
    vox_lin = torch.full((max_voxels + 1,), SENTINEL, dtype=torch.int32, device=dev)
    vox_lin.scatter_reduce_(0, write_slot, sorted_lin, "amin")
    vox_lin = vox_lin[:max_voxels]
    valid = vox_lin != SENTINEL
    lin_safe = torch.where(valid, vox_lin, 0)
    zc = lin_safe // (nx * ny)
    yc = (lin_safe // nx) % ny
    xc = lin_safe % nx
    coords = torch.stack([zc, yc, xc], dim=-1) * valid[:, None].to(torch.int32)

    counts = torch.zeros(max_voxels + 1, dtype=torch.int32, device=dev)
    counts.index_add_(
        0, torch.where(point_slot >= 0, point_slot, max_voxels).long(),
        torch.ones(n, dtype=torch.int32, device=dev),
    )
    counts = counts[:max_voxels]
    num_voxels = valid.sum(dtype=torch.int32)
    return VoxelizedPoints(point_slot, coords, valid, counts, num_voxels)


def voxel_mean(
    features: torch.Tensor, point_slot: torch.Tensor, counts: torch.Tensor, max_voxels: int
) -> torch.Tensor:
    """Segment-mean point features into voxel slots. `features` [N, C],
    returns [V, C]."""
    valid_pt = point_slot >= 0
    idx = torch.where(valid_pt, point_slot, max_voxels).long()
    sums = torch.zeros(
        (max_voxels + 1, features.shape[-1]), dtype=torch.float32, device=features.device
    )
    sums.index_add_(0, idx, torch.where(valid_pt[:, None], features, 0).float())
    denom = torch.clamp(counts, min=1).float()[:, None]
    return (sums[:max_voxels] / denom).to(features.dtype)


def voxel_max(
    features: torch.Tensor, point_slot: torch.Tensor, max_voxels: int, neg_inf: float = -1e9
) -> torch.Tensor:
    """Segment-max point features into voxel slots ([N, C] → [V, C]);
    points with slot −1 are left out and an empty slot gives 0 (the
    post-ReLU convention of pillar nets). The gradient of a slot's max is
    shared equally among the points that tie for it, as in efg_tpu."""
    valid_pt = point_slot >= 0
    idx = torch.where(valid_pt, point_slot, max_voxels).long()
    c = features.shape[-1]
    maxed = torch.full((max_voxels + 1, c), neg_inf, dtype=features.dtype,
                       device=features.device)
    maxed = maxed.scatter_reduce(0, idx[:, None].expand(-1, c),
                                 torch.where(valid_pt[:, None], features, neg_inf), "amax")
    maxed = maxed[:max_voxels]
    return torch.where(maxed <= neg_inf / 2, torch.zeros_like(maxed), maxed)
