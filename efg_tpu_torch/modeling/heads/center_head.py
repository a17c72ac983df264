"""CenterPoint head: separated regression heads, on-device label
assignment, fast focal + gathered L1 losses, decode and rotated NMS (port
of `efg_tpu/modeling/heads/center_head.py`).

Maps are NHWC at the module boundary like efg_tpu. Targets are computed
for the whole batch at once (efg_tpu vmaps a per-sample function).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.modeling.common.norms import BatchNorm
from efg_tpu_torch.ops.gaussian import gaussian_radius, splat_gaussians
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


# ---------------------------------------------------------------------------
# Label assignment
# ---------------------------------------------------------------------------


def centerpoint_targets(
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_mask: torch.Tensor,
    *,
    tasks: Sequence[Dict[str, Any]],
    feature_map_size: Tuple[int, int],
    pc_range: Sequence[float],
    voxel_size: Sequence[float],
    out_size_factor: int,
    gaussian_overlap: float,
    min_radius: int,
    with_vel: bool,
    r_cap: int = 12,
) -> List[Dict[str, torch.Tensor]]:
    """CenterPoint training targets per task. gt_boxes [B, G, 9] (x, y, z,
    dx, dy, dz, vx, vy, yaw), gt_classes [B, G] 1-based global class ids
    (0 = padding), gt_mask [B, G]; feature_map_size = (W, H). Returns
    per-task dicts of hm [B, H, W, C], anno_box [B, G, 8|10], ind, mask
    and cat [B, G]."""
    w_fm, h_fm = feature_map_size
    vx, vy = voxel_size[0], voxel_size[1]
    x0, y0 = pc_range[0], pc_range[1]

    yaw = gt_boxes[..., -1]
    yaw = yaw - torch.floor(yaw / (2 * math.pi) + 0.5) * (2 * math.pi)  # to [-π, π)

    l_px = gt_boxes[..., 3] / vx / out_size_factor
    w_px = gt_boxes[..., 4] / vy / out_size_factor
    radius = gaussian_radius(l_px, w_px, gaussian_overlap).to(torch.int32)
    radius = torch.clamp(radius, min=min_radius)
    size_ok = (l_px > 0) & (w_px > 0)

    ct_x = (gt_boxes[..., 0] - x0) / vx / out_size_factor
    ct_y = (gt_boxes[..., 1] - y0) / vy / out_size_factor
    cti_x, cti_y = ct_x.to(torch.int32), ct_y.to(torch.int32)  # truncation, as astype
    in_fm = (cti_x >= 0) & (cti_x < w_fm) & (cti_y >= 0) & (cti_y < h_fm)

    anno = [ct_x - cti_x.to(ct_x.dtype), ct_y - cti_y.to(ct_y.dtype), gt_boxes[..., 2]]
    anno += [torch.log(torch.clamp(gt_boxes[..., i], min=1e-4)) for i in (3, 4, 5)]
    if with_vel:
        anno += [gt_boxes[..., 6], gt_boxes[..., 7]]
    anno = torch.stack(anno + [torch.sin(yaw), torch.cos(yaw)], dim=-1)
    ind_all = cti_y * w_fm + cti_x
    centers = torch.stack([cti_x, cti_y], dim=-1)

    out, offset = [], 0
    for task in tasks:
        n_cls = int(task["num_classes"])
        in_task = (gt_classes > offset) & (gt_classes <= offset + n_cls)
        cat = torch.clamp(gt_classes - offset - 1, 0, n_cls - 1)
        m = gt_mask & in_task & size_ok & in_fm
        hm = splat_gaussians(centers, radius, cat, m, shape=(h_fm, w_fm, n_cls), r_cap=r_cap)
        out.append(dict(
            hm=hm,
            anno_box=anno * m[..., None].to(anno.dtype),
            ind=torch.where(m, ind_all, 0),
            mask=m,
            cat=torch.where(m, cat, 0),
        ))
        offset += n_cls
    return out


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _gather_feat(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """fmap [B, H, W, C], ind [B, M] flat (y·W + x) → [B, M, C]."""
    b, h, w, c = fmap.shape
    return torch.gather(fmap.reshape(b, h * w, c), 1, ind.long()[..., None].expand(-1, -1, c))


def fast_focal_loss(out, target, ind, mask, cat, eps: float = 1e-12) -> torch.Tensor:
    """CornerNet-style focal loss on sigmoided heatmaps out/target [B, H, W, C]."""
    m = mask.to(torch.float32)
    gt_weight = torch.pow(1 - target, 4)
    neg_loss = (torch.log(torch.clamp(1 - out, min=eps)) * torch.square(out) * gt_weight).sum()
    pos_pred = torch.gather(_gather_feat(out, ind), 2, cat.long()[..., None])[..., 0]
    num_pos = m.sum()
    pos_loss = (torch.log(torch.clamp(pos_pred, min=eps)) * torch.square(1 - pos_pred) * m).sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_loss(output, mask, ind, target) -> torch.Tensor:
    """Gathered L1 regression loss → per-dim vector [D]. output [B, H, W, D],
    target [B, M, D]."""
    pred = _gather_feat(output, ind)
    m = mask.to(torch.float32)[..., None]
    loss = torch.abs(pred * m - target * m)
    loss = loss / (m.sum() + 1e-4)
    return loss.sum(dim=(0, 1))


def center_head_loss(
    preds: List[Dict[str, torch.Tensor]],
    targets: List[Dict[str, torch.Tensor]],
    *,
    code_weights: Sequence[float],
    weight: float,
    with_vel: bool,
) -> Dict[str, torch.Tensor]:
    """CenterHead losses per task: `{t}_loss` (trained), the logged
    `{t}_hm_loss` / `{t}_loc_loss` (detached) and `{t}_num_positive`."""
    out: Dict[str, torch.Tensor] = {}
    for task_id, (pred, tgt) in enumerate(zip(preds, targets)):
        hm = torch.clamp(torch.sigmoid(pred["hm"]), 1e-4, 1 - 1e-4)
        hm_loss = fast_focal_loss(hm, tgt["hm"], tgt["ind"], tgt["mask"], tgt["cat"])
        parts = [pred["reg"], pred["height"], pred["dim"]]
        if with_vel:
            parts.append(pred["vel"])
        parts.append(pred["rot"])
        box_loss = reg_loss(torch.cat(parts, dim=-1), tgt["mask"], tgt["ind"], tgt["anno_box"])
        cw = torch.tensor(code_weights, dtype=box_loss.dtype, device=box_loss.device)
        loc_loss = (box_loss * cw).sum()
        out[f"{task_id}_loss"] = hm_loss + weight * loc_loss
        out[f"{task_id}_hm_loss"] = hm_loss.detach()
        out[f"{task_id}_loc_loss"] = loc_loss.detach()
        out[f"{task_id}_num_positive"] = tgt["mask"].to(torch.float32).sum()
    return out


# ---------------------------------------------------------------------------
# Decode + post-processing
# ---------------------------------------------------------------------------


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
