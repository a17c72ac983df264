"""RetinaNet, the anchor-based single-stage 2D detector (port of
`efg_tpu/models/retinanet.py`).

ResNet → FPN p3-p7 (FCOS's `_FPNP6P7`) → cls / box towers of four 3×3
convs without norms → 9 anchors a position. `cls_pred` emits A·C channels
read as A blocks of C at each position (and `box_pred` A blocks of 4), in
efg_tpu's NHWC row order (h, w, anchor), which is the anchors' order.
Targets: IoU matching with an ignore band [0.4, 0.5) and forced
low-quality matches; focal loss plus smooth-L1 (β 0.1) over the global
batch's foreground count.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.modeling.assigners.anchor_generator import Box2BoxTransform, grid_anchors
from efg_tpu_torch.modeling.backbones.resnet import ResNet, msra_conv
from efg_tpu_torch.models.centerpoint import resolve_device
from efg_tpu_torch.models.fcos import _FPNP6P7, _flat, nms_per_image, one_hot_fg
from efg_tpu_torch.models.voxel_detr import sigmoid_focal_loss
from efg_tpu_torch.ops.nms2d import iou_xyxy
from efg_tpu_torch.parallel import ddp
from efg_tpu_torch.utils import distributed as comm

ANCHOR_SIZES = ((32, 40, 50), (64, 80, 101), (128, 161, 203), (256, 322, 406), (512, 645, 812))
ASPECT_RATIOS = (0.5, 1.0, 2.0)


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes: int = 80, num_anchors: int = 9, num_convs: int = 4,
                 prior_prob: float = 0.01, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_convs = num_convs
        for tower in ("cls", "box"):
            for i in range(num_convs):
                setattr(self, f"{tower}_conv{i}", msra_conv(256, 256, 3, padding=1, bias=True,
                                                            generator=g))
        self.cls_pred = msra_conv(256, num_anchors * num_classes, 3, padding=1, bias=True,
                                  generator=g)
        with torch.no_grad():
            self.cls_pred.bias.fill_(-math.log((1 - prior_prob) / prior_prob))
        self.box_pred = msra_conv(256, num_anchors * 4, 3, padding=1, bias=True, generator=g)

    def _tower(self, tower: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"{tower}_conv{i}")(x))
        return x

    def forward(self, features: List[torch.Tensor]):
        logits = [self.cls_pred(self._tower("cls", x)) for x in features]
        deltas = [self.box_pred(self._tower("box", x)) for x in features]
        return logits, deltas


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int = 80, depth: int = 50, freeze_at: int = 2,
                 fpn_strides: Sequence[int] = (8, 16, 32, 64, 128), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.backbone = ResNet(depth=depth, out_features=("res3", "res4", "res5"),
                               freeze_at=freeze_at, generator=generator)
        self.fpn = _FPNP6P7(self.backbone.out_channels, generator=generator)
        self.head = RetinaNetHead(num_classes=num_classes, generator=generator)
        self.to(device)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        levels = self.fpn(self.backbone(images.permute(0, 3, 1, 2).contiguous()))
        logits, deltas = self.head(levels)
        return dict(
            logits=torch.cat([_flat(x, self.num_classes) for x in logits], dim=1),
            deltas=torch.cat([_flat(x, 4) for x in deltas], dim=1),
            shapes=[tuple(x.shape[2:]) for x in levels],
        )


def anchors_for(shapes, strides, device) -> torch.Tensor:
    """Every level's anchors [R, 4]."""
    per_level = grid_anchors(shapes, strides, ANCHOR_SIZES[: len(shapes)], ASPECT_RATIOS, device)
    return torch.cat(per_level, dim=0)


def retinanet_targets(anchors, gt_boxes, gt_classes, gt_mask, *, num_classes,
                      fg_thresh=0.5, bg_thresh=0.4):
    """IoU matching with an ignore band, batched: anchors [R, 4], GT [B, G,
    ·] → (cls [B, R] with num_classes = background and −1 = ignore, the
    matched GT slot [B, R]). An anchor that is the best (IoU ≥ max(best of
    the GT, 1e-5)) for some GT is foreground whatever its IoU."""
    iou = iou_xyxy(anchors, gt_boxes)  # [B, R, G]
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    best = iou.amax(dim=2)
    match = iou.argmax(dim=2)
    best_per_gt = iou.amax(dim=1)  # [B, G]
    is_best_of_gt = (iou >= torch.clamp(best_per_gt[:, None, :], min=1e-5)) & gt_mask[:, None, :]
    forced_fg = is_best_of_gt.any(dim=2)

    matched_cls = torch.gather(gt_classes, 1, match)
    cls = torch.where(best >= fg_thresh, matched_cls, num_classes)
    cls = torch.where((best < fg_thresh) & (best >= bg_thresh) & ~forced_fg, -1, cls)
    cls = torch.where(forced_fg, matched_cls, cls)
    return cls, match


def compute_loss(preds, batch, *, model_cfg):
    num_classes = model_cfg["num_classes"]
    coder = Box2BoxTransform()
    logits = preds["logits"]
    anchors = anchors_for(preds["shapes"], model_cfg["fpn_strides"], logits.device)
    gt_boxes = batch["gt_boxes2d"]
    cls_t, match = retinanet_targets(anchors, gt_boxes, batch["gt_classes2d"].long(),
                                     batch["gt_mask2d"], num_classes=num_classes)

    fg = (cls_t >= 0) & (cls_t < num_classes)
    valid = cls_t >= 0
    num_fg = torch.clamp(ddp.global_sum(fg.sum().float()), min=1.0)

    focal = sigmoid_focal_loss(logits, one_hot_fg(cls_t, fg, num_classes))
    loss_cls = (focal * valid[..., None]).sum() / num_fg

    matched_boxes = torch.gather(gt_boxes, 1, match[..., None].expand(-1, -1, 4))
    tgt_deltas = coder.get_deltas(anchors[None], matched_boxes)
    l1 = torch.abs(preds["deltas"] - tgt_deltas)
    beta = 0.1  # smooth l1
    sl1 = torch.where(l1 < beta, 0.5 * l1**2 / beta, l1 - 0.5 * beta)
    loss_box = (sl1 * fg[..., None]).sum() / num_fg

    return dict(loss_cls=loss_cls, loss_box_reg=loss_box, loss=loss_cls + loss_box,
                num_foreground=num_fg / comm.get_world_size())


def predict(preds, *, model_cfg, score_threshold=0.05, nms_threshold=0.5,
            pre_max=1000, post_max=100):
    coder = Box2BoxTransform()
    anchors = anchors_for(preds["shapes"], model_cfg["fpn_strides"], preds["logits"].device)
    boxes = coder.apply_deltas(preds["deltas"], anchors[None])
    return nms_per_image(torch.sigmoid(preds["logits"]), boxes, score_threshold=score_threshold,
                         nms_threshold=nms_threshold, pre_max=pre_max, post_max=post_max)


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the RetinaNet experiments' `net.py`:
    `model.retinanet` of the config."""
    mc = config.model.retinanet
    cfg = dict(num_classes=int(mc.num_classes), fpn_strides=list(mc.fpn_strides))
    module = RetinaNet(num_classes=cfg["num_classes"], depth=int(mc.depth),
                       freeze_at=int(mc.get("freeze_at", 2)),
                       fpn_strides=tuple(cfg["fpn_strides"]), device=device, generator=generator)
    return ModelDef(
        module, lambda batch: dict(images=batch["images"]),
        lambda preds, batch: compute_loss(preds, batch, model_cfg=cfg),
        lambda preds, batch: predict(preds, model_cfg=cfg,
                                     score_threshold=float(mc.get("score_threshold", 0.05)),
                                     nms_threshold=float(mc.get("nms_threshold", 0.5))))
