"""Loss functions, elementwise unless stated (port of
`efg_tpu/modeling/losses/common.py`): the focal losses, smooth L1, the
aligned 2D IoU / GIoU losses and the differentiable rotated 3D GIoU loss.
Each computes efg_tpu's expressions in the same order; the models keep
their own copies of the forms they train with."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from efg_tpu_torch.geometry.box_ops_torch import boxes_to_corners_3d, boxes_to_corners_bev
from efg_tpu_torch.ops.iou_rotated import _ensure_ccw, _quad_intersection_area


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise focal loss: the stable BCE with logits × (1 − p_t)^γ,
    weighted α / 1 − α by the target when α ≥ 0."""
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def sigmoid_focal_loss_star(logits, targets, alpha: float = 0.25, gamma: float = 1.0):
    """Focal loss*: −log σ(γ·logits·(2t − 1)) / γ, α-weighted when α ≥ 0."""
    shifted = gamma * (logits * (2 * targets - 1))
    loss = -F.logsigmoid(shifted) / gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def smooth_l1_loss(pred, target, beta: float = 1.0):
    """Huber / smooth L1 (plain L1 for β < 1e-5)."""
    d = torch.abs(pred - target)
    if beta < 1e-5:
        return d
    return torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta)


def iou_loss_2d(pred_xyxy, tgt_xyxy, loss_type: str = "giou", eps: float = 1e-7):
    """Pairwise-aligned 2D loss of xyxy boxes: `iou` (−log IoU),
    `linear_iou` (1 − IoU) or `giou` (1 − GIoU)."""
    lt = torch.maximum(pred_xyxy[..., :2], tgt_xyxy[..., :2])
    rb = torch.minimum(pred_xyxy[..., 2:], tgt_xyxy[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = torch.clamp(pred_xyxy[..., 2] - pred_xyxy[..., 0], min=0) * torch.clamp(
        pred_xyxy[..., 3] - pred_xyxy[..., 1], min=0)
    area_t = (tgt_xyxy[..., 2] - tgt_xyxy[..., 0]) * (tgt_xyxy[..., 3] - tgt_xyxy[..., 1])
    union = area_p + area_t - inter
    iou = inter / torch.clamp(union, min=eps)
    if loss_type == "iou":
        return -torch.log(torch.clamp(iou, eps, 1.0))
    if loss_type == "linear_iou":
        return 1 - iou
    lt_h = torch.minimum(pred_xyxy[..., :2], tgt_xyxy[..., :2])
    rb_h = torch.maximum(pred_xyxy[..., 2:], tgt_xyxy[..., 2:])
    wh_h = torch.clamp(rb_h - lt_h, min=0)
    hull = torch.clamp(wh_h[..., 0] * wh_h[..., 1], min=eps)
    return 1 - (iou - (hull - union) / hull)


def giou_loss_2d(pred_xyxy, tgt_xyxy, eps: float = 1e-7):
    return iou_loss_2d(pred_xyxy, tgt_xyxy, "giou", eps)


def rotated_giou_3d_loss(pred_boxes7, tgt_boxes7, eps: float = 1e-7):
    """Differentiable rotated 3D GIoU loss of aligned pairs [N, 7] → [N]:
    the BEV intersection by polygon clipping × the z overlap; the
    enclosing volume from the corners' box in the target's frame (so
    giou(x, x) = 1 for rotated boxes, and the hull is the convex one where
    the yaws agree), as efg_tpu's."""
    ca = _ensure_ccw(boxes_to_corners_bev(pred_boxes7))
    cb = _ensure_ccw(boxes_to_corners_bev(tgt_boxes7))
    inter_bev = _quad_intersection_area(ca, cb)
    za0 = pred_boxes7[:, 2] - pred_boxes7[:, 5] / 2
    za1 = pred_boxes7[:, 2] + pred_boxes7[:, 5] / 2
    zb0 = tgt_boxes7[:, 2] - tgt_boxes7[:, 5] / 2
    zb1 = tgt_boxes7[:, 2] + tgt_boxes7[:, 5] / 2
    zi = torch.clamp(torch.minimum(za1, zb1) - torch.maximum(za0, zb0), min=0)
    vol_i = inter_bev * zi
    vol_p = pred_boxes7[:, 3] * pred_boxes7[:, 4] * pred_boxes7[:, 5]
    vol_t = tgt_boxes7[:, 3] * tgt_boxes7[:, 4] * tgt_boxes7[:, 5]
    union = vol_p + vol_t - vol_i
    iou = vol_i / torch.clamp(union, min=eps)

    cp = boxes_to_corners_3d(pred_boxes7)
    ct = boxes_to_corners_3d(tgt_boxes7)
    yaw = tgt_boxes7[:, 6]
    c, s = torch.cos(-yaw), torch.sin(-yaw)

    def rot(corners):
        x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
        y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
        return torch.stack([x, y, corners[..., 2]], dim=-1)

    cp_r, ct_r = rot(cp), rot(ct)
    lo = torch.minimum(cp_r.amin(dim=-2), ct_r.amin(dim=-2))
    hi = torch.maximum(cp_r.amax(dim=-2), ct_r.amax(dim=-2))
    hull = torch.clamp(hi - lo, min=eps).prod(dim=-1)
    giou = iou - (hull - union) / torch.clamp(hull, min=eps)
    return 1 - giou
