"""Host-side (numpy) box geometry for the 3D processors: a copy of the
functions of `efg_tpu/geometry/box_ops_np.py` that the ported processors
call.

Box convention: ``[x, y, z, dx, dy, dz, (vx, vy,) yaw]`` with (x, y, z) the
geometric center and yaw the CCW rotation about +z.
"""

from __future__ import annotations

import numpy as np


def rotation_matrix_z(angle: np.ndarray) -> np.ndarray:
    """Row-vector CCW rotation matrices about +z: use as ``points @ R``.
    [..., 3, 3]."""
    c, s = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [c, s, zeros, -s, c, zeros, zeros, zeros, ones], axis=-1
    ).reshape(*angle.shape, 3, 3)


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate [N, P, 3+] points by per-row angles (extra channels pass through).
    Reference: `efg/geometry/box_ops.py:517`."""
    rot = rotation_matrix_z(angle)
    xyz = np.einsum("npi,nij->npj", points[:, :, :3], rot)
    return np.concatenate([xyz, points[:, :, 3:]], axis=-1)


_CORNER_TEMPLATE = (
    np.array(
        [
            [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
            [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        ],
        dtype=np.float64,
    )
    / 2.0
)


def boxes_to_corners_3d(boxes3d: np.ndarray) -> np.ndarray:
    """[N, 7+] center boxes → [N, 8, 3] corners (corner order matches reference
    `efg/geometry/box_ops.py:480-515`; yaw is the last column)."""
    boxes3d = np.asarray(boxes3d)
    n = boxes3d.shape[0]
    if n == 0:
        return np.zeros((0, 8, 3), dtype=boxes3d.dtype)
    yaw = boxes3d[:, -1]
    corners = boxes3d[:, None, 3:6] * _CORNER_TEMPLATE[None].astype(boxes3d.dtype)
    corners = rotate_points_along_z(corners, yaw)
    return corners + boxes3d[:, None, :3]


def mask_points_by_range(points: np.ndarray, pc_range) -> np.ndarray:
    """[N, 3+] → [N] bool, xyz inside the range box
    (reference `efg/geometry/box_ops.py:538`)."""
    pc_range = np.asarray(pc_range)
    return (
        (points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
        & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4])
        & (points[:, 2] >= pc_range[2]) & (points[:, 2] <= pc_range[5])
    )


def mask_boxes_outside_range_bev_z_bound(boxes: np.ndarray, limit_range) -> np.ndarray:
    """Keep boxes with centers in the BEV range whose z extent intersects the
    z bound (reference `efg/geometry/box_ops.py:459-478`)."""
    limit_range = np.asarray(limit_range)
    if boxes.shape[0] == 0:
        return np.zeros((0,), dtype=bool)
    mask1 = (
        (boxes[:, 0] >= limit_range[0]) & (boxes[:, 0] <= limit_range[3])
        & (boxes[:, 1] >= limit_range[1]) & (boxes[:, 1] <= limit_range[4])
    )
    b7 = boxes[:, [0, 1, 2, 3, 4, 5, boxes.shape[1] - 1]] if boxes.shape[1] > 7 else boxes
    corners = boxes_to_corners_3d(b7)
    z = corners[..., 2]
    outside_z = (z.max(axis=1) < limit_range[2]) ^ (z.min(axis=1) > limit_range[5])
    return mask1 & ~outside_z
