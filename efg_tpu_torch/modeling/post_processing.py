"""Result post-processing and mask pasting (port of
`efg_tpu/modeling/post_processing.py`): `detector_postprocess`,
`sem_seg_postprocess` (bilinear through `ops/resize.py`, JAX's resize)
and `paste_masks_in_image` (an inverse bilinear sample at every output
pixel)."""

from __future__ import annotations

from typing import Tuple

import torch

from efg_tpu_torch.ops.resize import resize


def detector_postprocess(boxes: torch.Tensor, scale: float, image_size: Tuple[int, int]):
    """xyxy boxes rescaled back to the original image and clipped to it."""
    h, w = image_size
    boxes = boxes / scale
    x = torch.clamp(boxes[..., 0::2], 0, w)
    y = torch.clamp(boxes[..., 1::2], 0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def sem_seg_postprocess(logits: torch.Tensor, out_size: Tuple[int, int]):
    """[C, h, w] → bilinear-resized [C, H, W]."""
    return resize(logits, (logits.shape[0], out_size[0], out_size[1]), "bilinear")


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor,
                         image_size: Tuple[int, int], threshold: float = 0.5) -> torch.Tensor:
    """Per-box masks [N, S, S] in box-local coordinates pasted onto the
    image canvas → [N, H, W] bool: each pixel centre inside its box
    samples the mask bilinearly (taps clamped to the mask) and reads
    above `threshold`."""
    h, w = image_size
    s = masks.shape[-1]
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    x0, y0, x1, y1 = (boxes[:, i, None] for i in range(4))  # [N, 1]
    gx = (xs[None] - x0) / torch.clamp(x1 - x0, min=1e-4) * s - 0.5  # [N, W]
    gy = (ys[None] - y0) / torch.clamp(y1 - y0, min=1e-4) * s - 0.5  # [N, H]
    x0i, y0i = torch.floor(gx), torch.floor(gy)
    n = masks.shape[0]
    rows = torch.arange(n, device=dev)[:, None, None]
    out = torch.zeros((n, h, w), dtype=masks.dtype, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = torch.clamp(x0i + dx, 0, s - 1).long()
            yi = torch.clamp(y0i + dy, 0, s - 1).long()
            wx = 1 - torch.abs(gx - (x0i + dx))
            wy = 1 - torch.abs(gy - (y0i + dy))
            out = out + masks[rows, yi[:, :, None], xi[:, None, :]] * (wy[:, :, None] * wx[:, None, :])
    inside = ((xs[None, None, :] >= x0[:, :, None]) & (xs[None, None, :] < x1[:, :, None])
              & (ys[None, :, None] >= y0[:, :, None]) & (ys[None, :, None] < y1[:, :, None]))
    return (out > threshold) & inside
