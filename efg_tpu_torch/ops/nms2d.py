"""2D axis-aligned IoU and class-aware greedy NMS (port of
`efg_tpu/ops/nms2d.py`).

The JAX op takes one image and is vmapped; this one takes a leading batch
dimension [B, N], like the port's `ops/nms.py`, whose stable top-k (ties
to the lower index, as `lax.top_k`) and greedy step it reuses. Boxes of
different classes never suppress each other: each image's boxes are moved
apart by label·(span + 1), span being the extent of that image's top-k
boxes (torchvision `batched_nms` semantics). The output is padded to
`post_max`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from efg_tpu_torch.ops.nms import NEG_INF, _greedy_from_matrix, _select, _top_k


def iou_xyxy(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """[..., N, 4] × [..., M, 4] (x0, y0, x1, y1) → [..., N, M] IoU; the
    leading dimensions broadcast."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=eps)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    *,
    iou_threshold: float,
    pre_max: int = 1000,
    post_max: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware greedy NMS. boxes [B, N, 4] xyxy, scores [B, N]
    (NEG_INF = invalid), labels [B, N]. Returns (indices [B, post_max] into
    the input, valid [B, post_max])."""
    n = boxes.shape[1]
    k = min(pre_max, n)
    top_scores, top_idx = _top_k(scores, k)
    tb = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    tl = torch.gather(labels, 1, top_idx)
    valid = top_scores > NEG_INF / 2

    # offset boxes per class so that different classes never overlap
    span = torch.clamp(tb.amax(dim=(1, 2)) - tb.amin(dim=(1, 2)), min=1.0)
    off = (tl.to(tb.dtype) * (span[:, None] + 1.0))[..., None]
    shifted = tb + off
    keep = _greedy_from_matrix(iou_xyxy(shifted, shifted) > iou_threshold, valid)
    out_idx, out_valid = _select(top_scores, top_idx, keep, min(post_max, k))
    if post_max > k:
        pad = post_max - k
        out_idx = torch.cat([out_idx, out_idx.new_zeros(out_idx.shape[0], pad)], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(out_valid.shape[0], pad)], dim=1)
    return out_idx, out_valid
