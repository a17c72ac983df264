"""Anchor-based multi-task 3D head (port of
`efg_tpu/modeling/heads/multigroup_head.py`).

Per task a 1×1 conv each for box regression (`conv_box`), classification
(`conv_cls`, its bias at the prior −log((1 − 0.01) / 0.01)) and, with
`use_dir`, direction classification (`conv_dir`), over two anchors (0° and
90°) per class per location. Maps are NHWC at the module boundary, as in
efg_tpu; the convs compute in f32 (flax's default).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d


class _Head(nn.Module):
    def __init__(self, cin: int, num_pred: int, num_cls: int, num_dir: int = 0,
                 prior_prob: float = 0.01, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_box = Conv2d(cin, num_pred, 1, bias=True, dtype=None, generator=generator)
        self.conv_cls = Conv2d(cin, num_cls, 1, bias=True, dtype=None, generator=generator)
        nn.init.constant_(self.conv_cls.bias, -math.log((1 - prior_prob) / prior_prob))
        self.conv_dir = (Conv2d(cin, num_dir, 1, bias=True, dtype=None, generator=generator)
                         if num_dir else None)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"box_preds": self.conv_box(x).permute(0, 2, 3, 1),
               "cls_preds": self.conv_cls(x).permute(0, 2, 3, 1)}
        if self.conv_dir is not None:
            out["dir_cls_preds"] = self.conv_dir(x).permute(0, 2, 3, 1)
        return out


class MultiGroupHead(nn.Module):
    """tasks: [{"num_classes": n, ...}]; 2n anchors a location for task of
    n classes, a box code of `box_code_size` (7, or 9 with velocity)."""

    def __init__(self, in_channels: int, tasks: Sequence[Dict[str, Any]], box_code_size: int = 7,
                 use_dir: bool = True, encode_background_as_zeros: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_tasks = len(tasks)
        for t, task in enumerate(tasks):
            n_cls = int(task["num_classes"])
            n_anchor = 2 * n_cls
            num_cls = n_anchor * (n_cls if encode_background_as_zeros else n_cls + 1)
            setattr(self, f"task{t}", _Head(in_channels, n_anchor * box_code_size, num_cls,
                                             n_anchor * 2 if use_dir else 0,
                                             generator=generator))

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x [B, H, W, C] → per task {box_preds, cls_preds[, dir_cls_preds]}
        NHWC maps."""
        x = x.permute(0, 3, 1, 2)
        return [getattr(self, f"task{t}")(x) for t in range(self.num_tasks)]
