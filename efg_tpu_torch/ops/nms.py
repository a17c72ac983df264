"""Fixed-shape NMS family, rotated BEV and circle (port of
`efg_tpu/ops/nms.py`).

The JAX ops take one sample and are vmapped; these take a leading batch
dimension [B, N]. Candidates are reduced to a static top-`pre_max` set by a
stable descending sort (`lax.top_k` breaks ties toward the lower index;
`torch.topk` on CUDA does not promise that), the pairwise suppression
matrix is computed vectorized, and the greedy selection runs as `pre_max`
eager steps over the whole batch at once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from efg_tpu_torch.ops.iou_rotated import iou_bev

NEG_INF = -1e9


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last dim: descending, ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _greedy_from_matrix(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy NMS given boolean suppression matrices [B, N, N] over
    score-descending candidates. suppress[b, i, j] means j (lower score) is
    suppressed by i. Returns keep masks [B, N]."""
    n = suppress.shape[-1]
    suppress = torch.triu(suppress, diagonal=1)  # only i < j suppresses
    keep = valid.clone()
    for i in range(n):
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    return keep


def _select(top_scores, top_idx, keep, post_max):
    keep_scores = torch.where(keep, top_scores, NEG_INF)
    sel_scores, sel = _top_k(keep_scores, post_max)
    return torch.gather(top_idx, 1, sel), sel_scores > NEG_INF / 2


def rotated_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    *,
    iou_threshold: float,
    pre_max: int = 1024,
    post_max: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated-BEV NMS. boxes [B, N, 7] (x, y, z, dx, dy, dz, yaw),
    scores [B, N] with NEG_INF for invalid rows. Returns (indices [B,
    post_max] into the input, valid mask [B, post_max])."""
    n = boxes.shape[1]
    k = min(pre_max, n)
    top_scores, top_idx = _top_k(scores, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, boxes.shape[-1]))
    valid = top_scores > NEG_INF / 2
    over = torch.stack([iou_bev(b, b) > iou_threshold for b in top_boxes])
    keep = _greedy_from_matrix(over, valid)
    out_idx, out_valid = _select(top_scores, top_idx, keep, min(post_max, k))
    if post_max > k:
        pad = post_max - k
        out_idx = torch.cat([out_idx, out_idx.new_zeros(out_idx.shape[0], pad)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(out_valid.shape[0], pad)], dim=1)
    return out_idx, out_valid


def circle_nms(
    centers: torch.Tensor,
    scores: torch.Tensor,
    *,
    min_radius: float,
    pre_max: int = 1024,
    post_max: int = 83,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Center-distance NMS: suppress j when a kept higher-score i lies
    within `min_radius` (squared L2 < r²). centers [B, N, 2], scores [B, N]."""
    n = centers.shape[1]
    k = min(pre_max, n)
    top_scores, top_idx = _top_k(scores, k)
    c = torch.gather(centers, 1, top_idx[..., None].expand(-1, -1, centers.shape[-1]))
    valid = top_scores > NEG_INF / 2
    d2 = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    keep = _greedy_from_matrix(d2 < min_radius**2, valid)
    return _select(top_scores, top_idx, keep, min(post_max, k))
