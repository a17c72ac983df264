"""CenterPoint head: separated regression heads, decode and rotated NMS
(port of the serving half of `efg_tpu/modeling/heads/center_head.py`;
target building and the losses come with the training slice).

Maps are NHWC at the module boundary like efg_tpu.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.modeling.common.norms import BatchNorm
from efg_tpu_torch.ops.nms import NEG_INF, circle_nms, rotated_nms


class SepHead(nn.Module):
    """Per-task separated heads: each output gets its own conv tower —
    (num_conv − 1) bf16 conv + BN + ReLU layers, then an f32 3×3 conv."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, final_kernel: int = 3, init_bias: float = -2.19):
        super().__init__()
        self.heads = dict(heads)
        pad = final_kernel // 2
        for name, (classes, num_conv) in self.heads.items():
            cin = in_channels
            for i in range(num_conv - 1):
                setattr(self, f"{name}_conv{i}",
                        Conv2d(cin, head_conv, final_kernel, padding=pad, bias=True))
                setattr(self, f"{name}_bn{i}", BatchNorm(head_conv))
                cin = head_conv
            final = Conv2d(cin, classes, final_kernel, padding=pad, bias=True, dtype=None)
            if name == "hm":
                nn.init.constant_(final.bias, init_bias)
            setattr(self, f"{name}_final", final)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x NCHW → {name: NHWC map}."""
        out = {}
        for name, (_, num_conv) in self.heads.items():
            h = x
            for i in range(num_conv - 1):
                h = getattr(self, f"{name}_conv{i}")(h)
                h = torch.relu(getattr(self, f"{name}_bn{i}")(h))
            out[name] = getattr(self, f"{name}_final")(h).permute(0, 2, 3, 1)
        return out


class CenterHead(nn.Module):
    """Shared conv + one SepHead per task."""

    def __init__(self, in_channels: int, tasks: Sequence[Dict[str, Any]],
                 common_heads: Dict[str, Tuple[int, int]], share_conv_channel: int = 64,
                 num_hm_conv: int = 2, init_bias: float = -2.19):
        super().__init__()
        self.shared_conv = Conv2d(in_channels, share_conv_channel, 3, padding=1, bias=True)
        self.shared_bn = BatchNorm(share_conv_channel)
        for t, task in enumerate(tasks):
            heads = dict(common_heads)
            heads["hm"] = (int(task["num_classes"]), num_hm_conv)
            setattr(self, f"task{t}", SepHead(share_conv_channel, heads, init_bias=init_bias))
        self.num_tasks = len(tasks)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x [B, H, W, C] → per-task {name: [B, H, W, c]}."""
        x = torch.relu(self.shared_bn(self.shared_conv(x.permute(0, 3, 1, 2))))
        return [getattr(self, f"task{t}")(x) for t in range(self.num_tasks)]


def decode_boxes(
    pred: Dict[str, torch.Tensor],
    *,
    pc_range: Sequence[float],
    voxel_size: Sequence[float],
    out_size_factor: int,
    with_vel: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense decode of one task head: (boxes [B, H·W, 7|9], scores
    [B, H·W, C])."""
    hm = torch.sigmoid(pred["hm"])
    b, h, w, c = hm.shape
    reg = pred["reg"].reshape(b, h * w, 2)
    hei = pred["height"].reshape(b, h * w, 1)
    dim = torch.exp(pred["dim"]).reshape(b, h * w, 3)
    rots = pred["rot"][..., 0:1].reshape(b, h * w, 1)
    rotc = pred["rot"][..., 1:2].reshape(b, h * w, 1)
    rot = torch.atan2(rots, rotc)

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=hm.dtype, device=hm.device),
        torch.arange(w, dtype=hm.dtype, device=hm.device),
        indexing="ij",
    )
    xs = xs.reshape(1, h * w, 1) + reg[:, :, 0:1]
    ys = ys.reshape(1, h * w, 1) + reg[:, :, 1:2]
    xs = xs * out_size_factor * voxel_size[0] + pc_range[0]
    ys = ys * out_size_factor * voxel_size[1] + pc_range[1]

    parts = [xs, ys, hei, dim]
    if with_vel:
        parts.append(pred["vel"].reshape(b, h * w, 2))
    parts.append(rot)
    return torch.cat(parts, dim=-1), hm.reshape(b, h * w, c)


def post_process_sample(
    boxes: torch.Tensor,
    scores_cls: torch.Tensor,
    *,
    score_threshold: float,
    post_center_range: Sequence[float],
    nms_iou_threshold: float,
    nms_pre_max_size: int,
    nms_post_max_size: int,
    use_circle_nms: bool = False,
    circle_min_radius: float = 1.0,
):
    """Filtering + class-agnostic rotated NMS over a batch of samples:
    boxes [B, N, 7|9], scores_cls [B, N, C] → dict of fixed-size [B, post]
    outputs (the JAX per-sample function under its vmap)."""
    pcr = torch.tensor(post_center_range, dtype=boxes.dtype, device=boxes.device)
    scores, labels = scores_cls.max(dim=-1)
    keep = (
        (scores > score_threshold)
        & (boxes[..., :3] >= pcr[:3]).all(dim=-1)
        & (boxes[..., :3] <= pcr[3:]).all(dim=-1)
    )
    masked_scores = torch.where(keep, scores, NEG_INF)
    nms_boxes = torch.cat([boxes[..., :6], boxes[..., -1:]], dim=-1)
    if use_circle_nms:
        idx, valid = circle_nms(
            nms_boxes[..., :2], masked_scores, min_radius=circle_min_radius,
            pre_max=nms_pre_max_size, post_max=nms_post_max_size,
        )
    else:
        idx, valid = rotated_nms(
            nms_boxes, masked_scores, iou_threshold=nms_iou_threshold,
            pre_max=nms_pre_max_size, post_max=nms_post_max_size,
        )
    box3d = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    return dict(
        box3d=box3d * valid[..., None].to(boxes.dtype),
        scores=torch.where(valid, torch.gather(scores, 1, idx), 0.0),
        labels=torch.where(valid, torch.gather(labels, 1, idx), -1),
        valid=valid,
    )
