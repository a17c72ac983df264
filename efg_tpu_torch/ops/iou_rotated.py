"""Rotated (BEV) box IoU as batched convex polygon clipping (port of
`efg_tpu/ops/iou_rotated.py`).

Sutherland–Hodgman clipping of one quad against the other with a fixed
8-vertex capacity, shoelace area. The JAX version vmaps one pair; here
every tensor carries a leading pair dimension, and `iou_bev` walks the
rows of the [N, M] matrix in chunks of about PAIRS_PER_CHUNK pairs so the
intermediates stay bounded (~1 GB at 4M pairs).
"""

from __future__ import annotations

import torch

from efg_tpu_torch.geometry.box_ops_torch import boxes_to_corners_bev

_CAP = 8
PAIRS_PER_CHUNK = 1 << 22  # pairs of the [N, M] IoU matrix clipped at once


def _clip_poly_by_edge(verts, count, p1, p2):
    """Clip polygons (verts [Q, CAP, 2], count [Q]) by the half-planes left
    of p1→p2 ([Q, 2] each). Emits, per input vertex i < count, the vertex
    itself when inside and the edge intersection when the edge crosses the
    clip line, compacted via interleaved cumsum positions."""
    q = verts.shape[0]
    idx = torch.arange(_CAP, device=verts.device)
    active = idx[None] < count[:, None]
    cur = verts
    nxt_idx = (idx[None] + 1) % torch.clamp(count, min=1)[:, None]
    nxt = torch.gather(verts, 1, nxt_idx[..., None].expand(q, _CAP, 2))

    e = p2 - p1
    d_cur = e[:, 0:1] * (cur[..., 1] - p1[:, 1:2]) - e[:, 1:2] * (cur[..., 0] - p1[:, 0:1])
    d_nxt = e[:, 0:1] * (nxt[..., 1] - p1[:, 1:2]) - e[:, 1:2] * (nxt[..., 0] - p1[:, 0:1])
    in_cur = d_cur >= 0
    in_nxt = d_nxt >= 0

    denom = d_cur - d_nxt
    t = d_cur / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    inter = cur + t[..., None] * (nxt - cur)

    emit_cur = in_cur & active
    emit_int = (in_cur ^ in_nxt) & active

    # interleave: [cur_0, int_0, cur_1, int_1, ...]
    flags = torch.stack([emit_cur, emit_int], dim=2).reshape(q, 2 * _CAP)
    pts = torch.stack([cur, inter], dim=2).reshape(q, 2 * _CAP, 2)
    pos = torch.cumsum(flags.to(torch.int32), 1, dtype=torch.int32) - 1
    out_count = torch.where(flags.any(dim=1), pos[:, -1] + 1, 0)
    write = torch.where(flags & (pos < _CAP), pos, _CAP).long()
    out = verts.new_zeros(q, _CAP + 1, 2)
    out.scatter_(1, write[..., None].expand(q, 2 * _CAP, 2), pts)
    return out[:, :_CAP], torch.clamp(out_count, max=_CAP)


def _poly_area(verts, count):
    idx = torch.arange(_CAP, device=verts.device)
    active = (idx[None] < count[:, None]).to(verts.dtype)
    nxt_idx = (idx[None] + 1) % torch.clamp(count, min=1)[:, None]
    nxt = torch.gather(verts, 1, nxt_idx[..., None].expand(verts.shape[0], _CAP, 2))
    cross = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    return 0.5 * torch.abs(torch.sum(cross * active, dim=1))


def _quad_intersection_area(qa, qb):
    """Intersection areas of CCW quads qa, qb [Q, 4, 2] → [Q]."""
    verts = qa.new_zeros(qa.shape[0], _CAP, 2)
    verts[:, :4] = qa
    count = torch.full((qa.shape[0],), 4, dtype=torch.int32, device=qa.device)
    for i in range(4):
        verts, count = _clip_poly_by_edge(verts, count, qb[:, i], qb[:, (i + 1) % 4])
    return _poly_area(verts, count)


def _ensure_ccw(corners):
    """Make quad winding CCW (shoelace sign) — clipping assumes it."""
    nxt = torch.roll(corners, -1, dims=-2)
    area2 = torch.sum(corners[..., 0] * nxt[..., 1] - nxt[..., 0] * corners[..., 1], dim=-1)
    return torch.where(area2[..., None, None] >= 0, corners, torch.flip(corners, dims=[-2]))


def intersection_area_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise BEV intersection areas [N, M] for 7+-dim center boxes."""
    ca = _ensure_ccw(boxes_to_corners_bev(boxes_a))
    cb = _ensure_ccw(boxes_to_corners_bev(boxes_b))
    n, m = ca.shape[0], cb.shape[0]
    step = max(1, PAIRS_PER_CHUNK // max(m, 1))
    rows = []
    for r0 in range(0, n, step):
        qa = ca[r0:r0 + step]
        r = qa.shape[0]
        qa = qa[:, None].expand(r, m, 4, 2).reshape(r * m, 4, 2)
        qb = cb[None].expand(r, m, 4, 2).reshape(r * m, 4, 2)
        rows.append(_quad_intersection_area(qa, qb).reshape(r, m))
    if not rows:
        return ca.new_zeros(0, m)
    return torch.cat(rows, dim=0)


def iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise rotated BEV IoU [N, M] (reference `boxes_iou_bev`)."""
    inter = intersection_area_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=eps)


def iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise rotated 3D IoU [N, M]: BEV polygon ∩ × z-overlap
    (reference `boxes_iou3d_gpu`, `iou3d_nms.cpp`)."""
    inter_bev = intersection_area_bev(boxes_a, boxes_b)
    za0 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za1 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb0 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb1 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zi = torch.clamp(torch.minimum(za1[:, None], zb1[None, :])
                     - torch.maximum(za0[:, None], zb0[None, :]), min=0)
    vol_i = inter_bev * zi
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return vol_i / torch.clamp(vol_a[:, None] + vol_b[None, :] - vol_i, min=eps)
