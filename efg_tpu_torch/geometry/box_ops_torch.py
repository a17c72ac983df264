"""Device-side box geometry (port of `efg_tpu/geometry/box_ops_jnp.py`).

Box convention: ``[x, y, z, dx, dy, dz, (vx, vy,) yaw]``, yaw CCW about +z.
"""

from __future__ import annotations

import math

import torch


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7+] boxes → [..., 4, 2] BEV corners (CCW)."""
    template = torch.tensor(
        [[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=boxes.dtype, device=boxes.device
    ) / 2.0
    local = boxes[..., None, 3:5] * template
    yaw = boxes[..., -1]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = local[..., 0] * c[..., None] - local[..., 1] * s[..., None]
    y = local[..., 0] * s[..., None] + local[..., 1] * c[..., None]
    return torch.stack([x, y], dim=-1) + boxes[..., None, :2]


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


def _aligned_parts(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """Broadcast corners and volumes of axis-aligned boxes (yaw ignored):
    (min_a, max_a, min_b, max_b, intersection volume, vol_a, vol_b)."""
    min_a = boxes_a[..., :3] - boxes_a[..., 3:6] / 2
    max_a = boxes_a[..., :3] + boxes_a[..., 3:6] / 2
    min_b = boxes_b[..., :3] - boxes_b[..., 3:6] / 2
    max_b = boxes_b[..., :3] + boxes_b[..., 3:6] / 2
    inter = torch.clamp(torch.minimum(max_a, max_b) - torch.maximum(min_a, min_b), min=0)
    return (min_a, max_a, min_b, max_b, inter.prod(dim=-1),
            boxes_a[..., 3:6].prod(dim=-1), boxes_b[..., 3:6].prod(dim=-1))


def aligned_iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Axis-aligned 3D IoU matrix [N, M] (ignores yaw): the formulation the
    reference DETR losses use."""
    *_, vol_i, vol_a, vol_b = _aligned_parts(boxes_a[:, None], boxes_b[None, :])
    return vol_i / (vol_a + vol_b - vol_i + eps)


def aligned_giou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Axis-aligned GIoU3D matrix [N, M] (differentiable)."""
    return aligned_giou_3d_pairs(boxes_a[:, None], boxes_b[None, :], eps)


def aligned_giou_3d_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                          eps: float = 1e-7) -> torch.Tensor:
    """GIoU3D of broadcast pairs [..., 7] × [..., 7] → [...]: each pair's
    value by the formula of `aligned_giou_3d`, e.g. its diagonal from
    aligned boxes [B, G, 7] without the [G, G] matrix."""
    min_a, max_a, min_b, max_b, vol_i, vol_a, vol_b = _aligned_parts(boxes_a, boxes_b)
    union = vol_a + vol_b - vol_i
    hull = torch.clamp(torch.maximum(max_a, max_b) - torch.minimum(min_a, min_b), min=eps)
    vol_h = hull.prod(dim=-1)
    return vol_i / (union + eps) - (vol_h - union) / (vol_h + eps)


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """points [..., P, 3+], angle [...] → rotated points (extra dims pass through)."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] * c[..., None] - points[..., 1] * s[..., None]
    y = points[..., 0] * s[..., None] + points[..., 1] * c[..., None]
    return torch.cat([x[..., None], y[..., None], points[..., 2:]], dim=-1)


def boxes_to_corners_3d(boxes3d: torch.Tensor) -> torch.Tensor:
    """[..., 7+] → [..., 8, 3] corners, in the corner order of `box_ops_np`."""
    template = torch.tensor(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
        dtype=boxes3d.dtype, device=boxes3d.device,
    ) / 2.0
    corners = boxes3d[..., None, 3:6] * template
    corners = rotate_points_along_z(corners, boxes3d[..., -1])
    return corners + boxes3d[..., None, :3]


def points_in_rbbox(points: torch.Tensor, boxes: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """[N, 3+] × [M, 7+] → [N, M] bool: each point inside each box grown by
    `margin` on every half-extent (the point turned into the box frame)."""
    pts = points[:, None, :3] - boxes[None, :, :3]
    yaw = boxes[:, -1]
    c, s = torch.cos(yaw), torch.sin(yaw)
    lx = pts[..., 0] * c[None] + pts[..., 1] * s[None]
    ly = -pts[..., 0] * s[None] + pts[..., 1] * c[None]
    lz = pts[..., 2]
    half = boxes[:, 3:6] / 2.0 + margin
    return ((lx.abs() <= half[None, :, 0]) & (ly.abs() <= half[None, :, 1])
            & (lz.abs() <= half[None, :, 2]))
