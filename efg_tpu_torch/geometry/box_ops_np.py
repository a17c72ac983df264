"""Host-side (numpy) 3D/BEV box geometry: a copy of
`efg_tpu/geometry/box_ops_np.py` (its numpy paths; efg_tpu's native C++
`points_in_rbbox` and `box_collision_test` are not ported).

Vectorized: points-in-rotated-box via the box-frame inverse transform,
polygon collision via segment intersection + containment. Used by the
host data pipeline (GT-database sampling, drops, crops, range filtering)
and the Waymo data preparation.

Box convention (matches reference / Waymo-in-EFG): ``[x, y, z, dx, dy, dz,
(vx, vy,) yaw]`` with (x, y, z) the geometric center and yaw the CCW
rotation about +z.
"""

from __future__ import annotations

import numpy as np


def limit_period(val: np.ndarray, offset: float = 0.5, period: float = np.pi) -> np.ndarray:
    """Wrap angle into [-offset*period, (1-offset)*period) (reference:
    `efg/geometry/box_ops_torch.py:229`)."""
    return val - np.floor(val / period + offset) * period


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


def boxes_to_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """[N, 7+] boxes → [N, 4, 2] BEV corners (x, y), CCW order."""
    boxes = np.asarray(boxes)
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0, 4, 2), dtype=boxes.dtype)
    template = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=boxes.dtype) / 2.0
    local = boxes[:, None, 3:5] * template[None]
    yaw = boxes[:, -1]
    c, s = np.cos(yaw), np.sin(yaw)
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([x, y], axis=-1) + boxes[:, None, :2]


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray, margin: float = 0.0) -> np.ndarray:
    """[N, 3+] points × [M, 7+] boxes → [N, M] bool membership.

    Implemented as the inverse rigid transform into each box frame (replaces
    the reference's surface-normal numba kernel, `efg/geometry/box_ops.py:98`).
    """
    points = np.asarray(points)[:, :3]
    boxes = np.asarray(boxes)
    if boxes.shape[0] == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    centers = boxes[:, :3]
    dims = boxes[:, 3:6]
    yaw = boxes[:, -1]
    # local = (p - c) @ R(-yaw)
    d = points[:, None, :] - centers[None, :, :]  # [N, M, 3]
    c, s = np.cos(yaw), np.sin(yaw)
    lx = d[..., 0] * c[None] + d[..., 1] * s[None]
    ly = -d[..., 0] * s[None] + d[..., 1] * c[None]
    lz = d[..., 2]
    half = dims / 2.0 + margin
    return (
        (np.abs(lx) <= half[None, :, 0])
        & (np.abs(ly) <= half[None, :, 1])
        & (np.abs(lz) <= half[None, :, 2])
    )


def corner_to_standup(corners: np.ndarray) -> np.ndarray:
    """[N, 4, 2] corners → [N, 4] axis-aligned (minx, miny, maxx, maxy)."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=-1)


def _cross2(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]
    ) * (b[..., 0] - o[..., 0])


def _segments_intersect(a0, a1, b0, b1):
    """Proper segment intersection test, broadcast over leading dims."""
    d1 = _cross2(b0, b1, a0)
    d2 = _cross2(b0, b1, a1)
    d3 = _cross2(a0, a1, b0)
    d4 = _cross2(a0, a1, b1)
    return ((d1 * d2) < 0) & ((d3 * d4) < 0)


def _points_in_convex_poly_bev(pts, poly):
    """pts [..., P, 2], poly [..., 4, 2] (consistent winding) → [..., P] bool."""
    verts = poly
    nxt = np.roll(poly, -1, axis=-2)
    # sign of cross(nxt-vert, p-vert) per edge; inside iff all same sign
    e = nxt - verts  # [..., 4, 2]
    d = pts[..., :, None, :] - verts[..., None, :, :]  # [..., P, 4, 2]
    cross = e[..., None, :, 0] * d[..., 1] - e[..., None, :, 1] * d[..., 0]
    return (cross >= 0).all(axis=-1) | (cross <= 0).all(axis=-1)


def box_collision_test(corners_a: np.ndarray, corners_b: np.ndarray) -> np.ndarray:
    """[N, 4, 2] × [K, 4, 2] BEV corner polygons → [N, K] bool overlap.

    Vectorized equivalent of the reference's numba edge-intersection +
    containment test (`efg/geometry/box_ops.py:27-96`): overlap iff any edge
    pair properly intersects or one polygon contains the other's corner.
    """
    N, K = corners_a.shape[0], corners_b.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=bool)
    su_a = corner_to_standup(corners_a)
    su_b = corner_to_standup(corners_b)
    bb = (
        (np.minimum(su_a[:, None, 2], su_b[None, :, 2]) > np.maximum(su_a[:, None, 0], su_b[None, :, 0]))
        & (np.minimum(su_a[:, None, 3], su_b[None, :, 3]) > np.maximum(su_a[:, None, 1], su_b[None, :, 1]))
    )

    a0 = corners_a  # [N, 4, 2]
    a1 = np.roll(corners_a, -1, axis=1)
    b0 = corners_b
    b1 = np.roll(corners_b, -1, axis=1)
    inter = _segments_intersect(
        a0[:, None, :, None, :], a1[:, None, :, None, :],
        b0[None, :, None, :, :], b1[None, :, None, :, :],
    ).any(axis=(2, 3))

    contain_ab = _points_in_convex_poly_bev(
        corners_b[None, :, :, :], corners_a[:, None, :, :]
    ).any(axis=-1)
    contain_ba = _points_in_convex_poly_bev(
        corners_a[:, None, :, :], corners_b[None, :, :, :].repeat(N, axis=0)
    ).any(axis=-1)
    return bb & (inter | contain_ab | contain_ba)


def mask_points_by_range(points: np.ndarray, pc_range) -> np.ndarray:
    """[N, 3+] → [N] bool, xyz inside the range box
    (reference `efg/geometry/box_ops.py:538`)."""
    pc_range = np.asarray(pc_range)
    return (
        (points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
        & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4])
        & (points[:, 2] >= pc_range[2]) & (points[:, 2] <= pc_range[5])
    )


def mask_points_by_range_bev(points: np.ndarray, pc_range) -> np.ndarray:
    pc_range = np.asarray(pc_range)
    return (
        (points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
        & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4])
    )


def mask_boxes_outside_range_center(boxes: np.ndarray, limit_range) -> np.ndarray:
    """Keep boxes whose center lies in range (reference `box_ops.py:438`)."""
    limit_range = np.asarray(limit_range)
    c = boxes[:, :3]
    return ((c >= limit_range[:3]) & (c <= limit_range[3:6])).all(axis=-1)


def mask_boxes_outside_range(boxes: np.ndarray, limit_range, min_num_corners: int = 8) -> np.ndarray:
    """Keep boxes with ≥min_num_corners corners in range (reference `box_ops.py:423`)."""
    limit_range = np.asarray(limit_range)
    if boxes.shape[1] > 7:
        boxes = boxes[:, [0, 1, 2, 3, 4, 5, boxes.shape[1] - 1]]
    corners = boxes_to_corners_3d(boxes)
    ok = ((corners >= limit_range[:3]) & (corners <= limit_range[3:])).all(axis=-1)
    return ok.sum(axis=1) >= min_num_corners


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


def gaussian_radius(det_size, min_overlap: float = 0.5) -> float:
    """CenterNet gaussian radius from box footprint (reference:
    CenterPoint playground `center_utils.py:10-30`)."""
    height, width = det_size
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1**2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2**2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3**2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)
