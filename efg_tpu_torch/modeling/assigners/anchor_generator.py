"""Dense multi-level anchors and the (dx, dy, dw, dh) box codec (port of
`efg_tpu/modeling/assigners/anchor_generator.py`), on the device of the
caller's tensors.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


def generate_cell_anchors(sizes, aspect_ratios, device=None) -> torch.Tensor:
    """[A, 4] xyxy anchors centred at the origin, sizes outer, aspect
    ratios inner (h / w = ratio, area = size²)."""
    anchors = []
    for size in sizes:
        area = size**2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def grid_anchors(
    shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    sizes_per_level: Sequence[Sequence[float]],
    aspect_ratios: Sequence[float],
    device=None,
) -> List[torch.Tensor]:
    """Per-level anchors [(H·W·A, 4) ...], rows in (h, w, anchor) order,
    centred at (i + 0.5)·stride."""
    out = []
    for (h, w), stride, sizes in zip(shapes, strides, sizes_per_level):
        cell = generate_cell_anchors(sizes, aspect_ratios, device)
        ys, xs = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride,
            (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride,
            indexing="ij",
        )
        shift = torch.stack([xs, ys, xs, ys], dim=-1).reshape(-1, 1, 4)
        out.append((shift + cell[None]).reshape(-1, 4))
    return out


class Box2BoxTransform:
    """The (dx, dy, dw, dh) codec with per-coordinate weights; dw and dh
    are clamped at `scale_clamp` before the exp."""

    def __init__(self, weights=(1.0, 1.0, 1.0, 1.0), scale_clamp=math.log(1000.0 / 16)):
        self.weights = weights
        self.scale_clamp = scale_clamp

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        sw = src[..., 2] - src[..., 0]
        sh = src[..., 3] - src[..., 1]
        scx = src[..., 0] + sw / 2
        scy = src[..., 1] + sh / 2
        tw = target[..., 2] - target[..., 0]
        th = target[..., 3] - target[..., 1]
        tcx = target[..., 0] + tw / 2
        tcy = target[..., 1] + th / 2
        wx, wy, ww, wh = self.weights
        sw_ = torch.clamp(sw, min=1e-6)
        sh_ = torch.clamp(sh, min=1e-6)
        return torch.stack(
            [
                wx * (tcx - scx) / sw_,
                wy * (tcy - scy) / sh_,
                ww * torch.log(torch.clamp(tw, min=1e-6) / sw_),
                wh * torch.log(torch.clamp(th, min=1e-6) / sh_),
            ],
            dim=-1,
        )

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + w / 2
        cy = boxes[..., 1] + h / 2
        wx, wy, ww, wh = self.weights
        dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
        dw = torch.clamp(deltas[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(deltas[..., 3] / wh, max=self.scale_clamp)
        pcx = dx * w + cx
        pcy = dy * h + cy
        pw = torch.exp(dw) * w
        ph = torch.exp(dh) * h
        return torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], dim=-1)
