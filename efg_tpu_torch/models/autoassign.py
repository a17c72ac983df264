"""AutoAssign: fully differentiable label assignment for dense detection
(port of `efg_tpu/models/autoassign.py`).

FCOS's trunk and head (objectness on the box tower) plus a learnable
per-class Gaussian center prior (`mu`, `sigma`, both [C, 2]), trained by
the positive and negative bag losses, batched over images, GT slots and
positions. Serving is FCOS's decode and NMS.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.models import fcos as F
from efg_tpu_torch.ops.nms2d import iou_xyxy
from efg_tpu_torch.parallel import ddp


class AutoAssign(F.FCOS):
    """FCOS with the center prior; `mu` starts at 0, `sigma` at 0.9."""

    flax_params = ("mu", "sigma")

    def __init__(self, num_classes: int = 80, **kw):
        super().__init__(num_classes=num_classes, **kw)
        dev = next(self.parameters()).device
        self.mu = nn.Parameter(torch.zeros(num_classes, 2, device=dev))
        self.sigma = nn.Parameter(torch.full((num_classes, 2), 0.9, device=dev))

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        preds = super().forward(images)
        preds["mu"] = self.mu
        preds["sigma"] = self.sigma
        return preds


def compute_loss(preds, batch, *, model_cfg):
    """efg_tpu's bag losses. The foreground (GT) count and the center
    prior's mass are the global batch's, and `loss_norm` is the mean over
    the global batch's images, so the ranks' losses add up to efg_tpu's."""
    strides_list = model_cfg["fpn_strides"]
    reg_weight = model_cfg.get("reg_weight", 5.0)
    alpha = model_cfg.get("focal_alpha", 0.25)
    gamma = model_cfg.get("focal_gamma", 2.0)

    dev = preds["logits"].device
    shifts, lvl = F.all_shifts(preds["shapes"], strides_list, dev)  # [R, 2], [R]
    strides = torch.tensor(strides_list, dtype=torch.float32, device=dev)[lvl]  # [R]

    cls_prob = torch.sigmoid(preds["logits"])      # [B, R, C]
    obj_prob = torch.sigmoid(preds["centerness"])  # [B, R, 1]
    deltas = preds["deltas"]                       # [B, R, 4]
    mu, sigma = preds["mu"], preds["sigma"]
    gt_boxes, gt_mask = batch["gt_boxes2d"], batch["gt_mask2d"]
    gt_classes = batch["gt_classes2d"].long()
    maskf = gt_mask.to(cls_prob.dtype)
    b, r, c = cls_prob.shape
    g = gt_boxes.shape[1]

    # ltrb of each position against each GT: [B, G, R, 4]
    sx, sy = shifts[None, None, :, 0], shifts[None, None, :, 1]
    tgt_deltas = torch.stack([sx - gt_boxes[..., 0, None], sy - gt_boxes[..., 1, None],
                              gt_boxes[..., 2, None] - sx, gt_boxes[..., 3, None] - sy], dim=-1)
    in_box = (tgt_deltas.amin(dim=-1) > 0) & gt_mask[:, :, None]

    # center prior, a learnable Gaussian per class: [B, G, R]
    centers = (tgt_deltas[..., :2] - tgt_deltas[..., 2:]) / 2
    d = centers / strides[None, None, :, None]
    normal = torch.exp(
        -((d - mu[gt_classes][:, :, None]) ** 2) / (2 * sigma[gt_classes][:, :, None] ** 2)
    ).prod(dim=-1)

    composed = (torch.gather(cls_prob, 2, gt_classes[:, None, :].expand(b, r, g)).transpose(1, 2)
                * obj_prob[:, None, :, 0])  # [B, G, R]
    giou = F._giou_ltrb(deltas[:, None], tgt_deltas)
    reg_prob = torch.exp(-(1 - giou) * reg_weight)

    # positive bag loss per GT
    logits = composed * reg_prob
    w = torch.exp(3 * logits) * normal * in_box
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    bag = (w * logits).sum(dim=-1)
    pos_loss = -torch.log(torch.clamp(bag, 1e-12, 1.0)) * maskf  # [B, G]

    # each position's best IoU with any GT, its predicted box held fixed,
    # min-max normalised per GT over that GT's positions and scattered by
    # class (a max over GT slots of one class): [B, R, C]
    with torch.no_grad():
        pred_boxes = torch.stack([shifts[None, :, 0] - deltas[..., 0],
                                  shifts[None, :, 1] - deltas[..., 1],
                                  shifts[None, :, 0] + deltas[..., 2],
                                  shifts[None, :, 1] + deltas[..., 3]], dim=-1)
        iou = torch.where(gt_mask[:, :, None], iou_xyxy(gt_boxes, pred_boxes), 0.0)
        v = 1.0 / torch.clamp(1.0 - iou.amax(dim=1), min=1e-12)  # [B, R]
        big = 1e30
        vmin = torch.where(in_box, v[:, None, :], big).amin(dim=-1)
        vmax = torch.where(in_box, v[:, None, :], -big).amax(dim=-1)
        norm_v = (v[:, None, :] - vmin[..., None] + 1e-12) / torch.clamp(
            vmax[..., None] - vmin[..., None], min=1e-12)
        norm_v = torch.clamp(torch.where(in_box, norm_v, 0.0), 0.0, 1.0)
        box_prob = torch.zeros_like(cls_prob).scatter_reduce(
            2, gt_classes[:, None, :].expand(b, r, g), norm_v.transpose(1, 2), reduce="amax",
            include_self=True)

    neg = cls_prob * obj_prob * (1 - box_prob)
    neg_loss = (neg**gamma) * (-torch.log(torch.clamp(1 - neg, 1e-12, 1.0)))

    prior_mass = (normal * in_box).sum(dim=(1, 2))  # [B]
    norm_loss = maskf.sum(dim=1) / torch.clamp(prior_mass, min=1e-12)
    num_fg = torch.clamp(ddp.global_sum(maskf.sum()), min=1.0)
    num_bg = torch.clamp(ddp.global_sum(prior_mass.sum()), min=1.0)
    loss_pos = pos_loss.sum() / num_fg * alpha
    loss_neg = neg_loss.sum() / num_bg * (1 - alpha)
    loss_norm = norm_loss.sum() / ddp.global_batch(b)[0] * (1 - alpha)
    return dict(loss_pos=loss_pos, loss_neg=loss_neg, loss_norm=loss_norm,
                loss=loss_pos + loss_neg + loss_norm)


predict = F.predict  # FCOS's decode and NMS


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the AutoAssign experiments' `net.py`:
    `model.autoassign` of the config."""
    mc = config.model.autoassign
    cfg = dict(num_classes=int(mc.num_classes), fpn_strides=list(mc.fpn_strides))
    module = AutoAssign(num_classes=cfg["num_classes"], depth=int(mc.depth),
                        freeze_at=int(mc.get("freeze_at", 2)),
                        fpn_strides=tuple(cfg["fpn_strides"]), device=device, generator=generator)
    return ModelDef(
        module, lambda batch: dict(images=batch["images"]),
        lambda preds, batch: compute_loss(preds, batch, model_cfg=cfg),
        lambda preds, batch: predict(preds, model_cfg=cfg,
                                     score_threshold=float(mc.get("score_threshold", 0.05)),
                                     nms_threshold=float(mc.get("nms_threshold", 0.6))))
