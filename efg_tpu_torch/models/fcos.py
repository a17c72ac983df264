"""FCOS, the anchor-free single-stage 2D detector (port of
`efg_tpu/models/fcos.py`).

ResNet → FPN p3-p7 (`_FPNP6P7`) → shared 4-conv cls / box towers with
GroupNorm, a learnable scale per level, centerness on the box tower. The
module takes the batch's NHWC images and runs NCHW inside; its flat
outputs are [B, R, ·] with the positions of every level in (h, w) order,
levels one after another, as efg_tpu's `reshape(b, -1, C)` of its NHWC
maps and `level_shifts`. GT assignment (`fcos_targets`) is vectorized over
the batch, the GT slots and the positions; the losses are efg_tpu's.

Under data parallelism each rank holds a slice of the batch: the loss
normalisers (`num_fg`, `num_tgt`) are sums over the global batch
(`ddp.global_sum`), so the ranks' losses add up to efg_tpu's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.modeling.backbones.resnet import GN_EPS, ResNet, msra_conv
from efg_tpu_torch.modeling.backbones.rpn import Conv2d
from efg_tpu_torch.models.centerpoint import resolve_device
from efg_tpu_torch.models.voxel_detr import sigmoid_focal_loss
from efg_tpu_torch.ops.nms import NEG_INF
from efg_tpu_torch.ops.nms2d import batched_nms
from efg_tpu_torch.parallel import ddp
from efg_tpu_torch.utils import distributed as comm

INF = 1e8
SIZES_OF_INTEREST = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          generator: Optional[torch.Generator] = None) -> Conv2d:
    """An f32 conv with bias and flax's default padding rule for these
    layers (k // 2)."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=True, dtype=None,
                  generator=generator)


class _FPNP6P7(nn.Module):
    """FPN on res3-res5 with the LastLevelP6P7 top block on p5: lateral
    1×1 convs, the top-down path (exact 2× nearest upsample), 3×3 output
    convs, p6 = conv_s2(p5), p7 = conv_s2(relu(p6))."""

    NAMES = ("res3", "res4", "res5")

    def __init__(self, in_channels: Dict[str, int], out_channels: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for f in self.NAMES:
            setattr(self, f"lateral_{f}", _conv(in_channels[f], out_channels, 1, generator=generator))
            setattr(self, f"output_{f}", _conv(out_channels, out_channels, 3, generator=generator))
        self.p6 = _conv(out_channels, out_channels, 3, stride=2, generator=generator)
        self.p7 = _conv(out_channels, out_channels, 3, stride=2, generator=generator)

    def forward(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        prev = None
        outs = {}
        for f in reversed(self.NAMES):
            lat = getattr(self, f"lateral_{f}")(feats[f])
            if prev is not None:
                lat = lat + F.interpolate(prev, scale_factor=2, mode="nearest")
            prev = lat
            outs[f] = getattr(self, f"output_{f}")(prev)
        p6 = self.p6(outs["res5"])
        p7 = self.p7(torch.relu(p6))
        return [outs["res3"], outs["res4"], outs["res5"], p6, p7]


class FCOSHead(nn.Module):
    """The cls and box towers (conv + GN(32) + ReLU, 256 wide), cls_pred
    with the prior-probability bias, box_pred scaled per level then ReLU,
    ctr_pred on the box tower. `scales` [num_levels] is a parameter of the
    head itself (`flax_params`: the weight mapper takes it as it is)."""

    flax_params = ("scales",)

    def __init__(self, num_classes: int = 80, num_convs: int = 4, num_levels: int = 5,
                 prior_prob: float = 0.01, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_convs = num_convs
        for tower in ("cls", "box"):
            for i in range(num_convs):
                setattr(self, f"{tower}_conv{i}", msra_conv(256, 256, 3, padding=1, bias=True,
                                                            generator=g))
                setattr(self, f"{tower}_gn{i}", nn.GroupNorm(32, 256, eps=GN_EPS))
        self.cls_pred = msra_conv(256, num_classes, 3, padding=1, bias=True, generator=g)
        with torch.no_grad():
            self.cls_pred.bias.fill_(-math.log((1 - prior_prob) / prior_prob))
        self.box_pred = msra_conv(256, 4, 3, padding=1, bias=True, generator=g)
        self.ctr_pred = msra_conv(256, 1, 3, padding=1, bias=True, generator=g)
        self.scales = nn.Parameter(torch.ones(num_levels))

    def _tower(self, tower: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"{tower}_gn{i}")(getattr(self, f"{tower}_conv{i}")(x)))
        return x

    def forward(self, features: List[torch.Tensor]):
        logits, bboxes, ctrs = [], [], []
        for lvl, x in enumerate(features):
            c = self._tower("cls", x)
            b = self._tower("box", x)
            logits.append(self.cls_pred(c))
            bboxes.append(torch.relu(self.box_pred(b) * self.scales[lvl]))
            ctrs.append(self.ctr_pred(b))
        return logits, bboxes, ctrs


def _flat(x: torch.Tensor, c: int) -> torch.Tensor:
    """An NCHW map [B, c·k, H, W] → [B, H·W·k, c] in efg_tpu's NHWC row
    order (h, w, then the k blocks of c channels)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, c)


def level_shifts(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 device=None) -> List[torch.Tensor]:
    """Per-level pixel shifts [(H·W, 2) ...] as (x, y) = (i + 0.5)·stride,
    h-major, f32."""
    out = []
    for (h, w), s in zip(shapes, strides):
        ys, xs = torch.meshgrid((torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s,
                                (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s,
                                indexing="ij")
        out.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1))
    return out


class FCOS(nn.Module):
    """ResNet (backbone) → `_FPNP6P7` (fpn) → `FCOSHead` (head). Built on
    `device` (default: the card), its initial weights drawn on the CPU
    from `generator`."""

    def __init__(self, num_classes: int = 80, depth: int = 50,
                 fpn_strides: Sequence[int] = (8, 16, 32, 64, 128), freeze_at: int = 2,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.fpn_strides = tuple(fpn_strides)
        self.backbone = ResNet(depth=depth, out_features=("res3", "res4", "res5"),
                               freeze_at=freeze_at, generator=generator)
        self.fpn = _FPNP6P7(self.backbone.out_channels, generator=generator)
        self.head = FCOSHead(num_classes=num_classes, num_levels=5, generator=generator)
        self.to(device)

    def levels(self, images: torch.Tensor) -> List[torch.Tensor]:
        """NHWC images [B, H, W, 3] → the FPN's NCHW maps p3-p7."""
        return self.fpn(self.backbone(images.permute(0, 3, 1, 2).contiguous()))

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        levels = self.levels(images)
        logits, bboxes, ctrs = self.head(levels)
        return dict(
            logits=torch.cat([_flat(x, self.num_classes) for x in logits], dim=1),
            deltas=torch.cat([_flat(x * s, 4) for x, s in zip(bboxes, self.fpn_strides)], dim=1),
            centerness=torch.cat([_flat(x, 1) for x in ctrs], dim=1),
            shapes=[tuple(x.shape[2:]) for x in levels],
        )


# ---------------------------------------------------------------------------
# GT assignment (efg_tpu's `fcos_targets`, batched)
# ---------------------------------------------------------------------------


def fcos_targets(
    shifts: torch.Tensor,          # [R, 2] all-level shifts
    level_of_shift: torch.Tensor,  # [R] level index
    strides: torch.Tensor,         # [n_levels]
    soi: torch.Tensor,             # [n_levels, 2]
    gt_boxes: torch.Tensor,        # [B, G, 4] xyxy
    gt_classes: torch.Tensor,      # [B, G] 0-based
    gt_mask: torch.Tensor,         # [B, G]
    *,
    num_classes: int,
    center_sampling_radius: float = 1.5,
):
    """→ (classes [B, R] (num_classes = background), deltas [B, R, 4],
    centerness [B, R]). A position takes the smallest-area GT that holds it
    (in its center region when center_sampling_radius > 0) and whose
    largest delta is within the level's size of interest; ties take the
    first GT slot."""
    sx, sy = shifts[None, None, :, 0], shifts[None, None, :, 1]
    l = sx - gt_boxes[..., 0, None]
    t = sy - gt_boxes[..., 1, None]
    rr = gt_boxes[..., 2, None] - sx
    bb = gt_boxes[..., 3, None] - sy
    deltas = torch.stack([l, t, rr, bb], dim=-1)  # [B, G, R, 4]

    if center_sampling_radius > 0:
        centers = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2
        radius = strides[level_of_shift] * center_sampling_radius  # [R]
        cb_lo = torch.maximum(centers[:, :, None, :] - radius[None, None, :, None],
                              gt_boxes[:, :, None, :2])
        cb_hi = torch.minimum(centers[:, :, None, :] + radius[None, None, :, None],
                              gt_boxes[:, :, None, 2:])
        cd = torch.cat([shifts[None, None] - cb_lo, cb_hi - shifts[None, None]], dim=-1)
        in_box = cd.amin(dim=-1) > 0
    else:
        in_box = deltas.amin(dim=-1) > 0

    max_d = deltas.amax(dim=-1)
    lvl_soi = soi[level_of_shift]
    cared = (max_d >= lvl_soi[None, None, :, 0]) & (max_d <= lvl_soi[None, None, :, 1])

    area = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    pos_area = torch.where(in_box & cared & gt_mask[:, :, None], area[:, :, None],
                           torch.full_like(max_d, INF))
    min_area = pos_area.amin(dim=1)
    match = pos_area.argmin(dim=1)  # [B, R]

    cls = torch.where(min_area < INF, torch.gather(gt_classes, 1, match),
                      torch.full_like(match, num_classes))
    r = shifts.shape[0]
    reg = torch.gather(deltas, 1, match[:, None, :, None].expand(-1, 1, r, 4))[:, 0]  # [B, R, 4]
    lr_ = reg[..., [0, 2]]
    tb_ = reg[..., [1, 3]]
    ctr = torch.sqrt(
        torch.clamp(lr_.amin(-1) / torch.clamp(lr_.amax(-1), min=1e-9), min=0)
        * torch.clamp(tb_.amin(-1) / torch.clamp(tb_.amax(-1), min=1e-9), min=0)
    )
    return cls, reg, ctr


def _giou_ltrb(pred: torch.Tensor, tgt: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """GIoU between ltrb deltas around the same shift (efg_tpu's
    `_giou_ltrb`)."""
    p_l, p_t, p_r, p_b = pred.unbind(-1)
    g_l, g_t, g_r, g_b = tgt.unbind(-1)
    p_area = (p_l + p_r) * (p_t + p_b)
    g_area = (g_l + g_r) * (g_t + g_b)
    iw = torch.minimum(p_l, g_l) + torch.minimum(p_r, g_r)
    ih = torch.minimum(p_t, g_t) + torch.minimum(p_b, g_b)
    inter = torch.clamp(iw, min=0) * torch.clamp(ih, min=0)
    union = p_area + g_area - inter
    iou = inter / torch.clamp(union, min=eps)
    cw = torch.maximum(p_l, g_l) + torch.maximum(p_r, g_r)
    ch = torch.maximum(p_t, g_t) + torch.maximum(p_b, g_b)
    hull = torch.clamp(cw * ch, min=eps)
    return iou - (hull - union) / hull


def all_shifts(shapes, strides, device):
    """(shifts [R, 2], level index [R]) over every level."""
    shift_list = level_shifts(shapes, strides, device=device)
    lvl = torch.cat([torch.full((s.shape[0],), i, dtype=torch.long, device=device)
                     for i, s in enumerate(shift_list)])
    return torch.cat(shift_list, dim=0), lvl


def one_hot_fg(cls_t: torch.Tensor, fg: torch.Tensor, num_classes: int) -> torch.Tensor:
    """efg_tpu's one_hot(where(fg, cls, C), C + 1)[..., :C] in f32."""
    return F.one_hot(torch.where(fg, cls_t, num_classes), num_classes + 1)[..., :num_classes].float()


def compute_loss(preds, batch, *, model_cfg):
    """batch: gt_boxes2d [B, G, 4], gt_classes2d [B, G] 0-based,
    gt_mask2d [B, G]. Focal class loss and centerness BCE over the
    foreground count, centerness-weighted GIoU loss over the centerness
    sum; both normalisers are the global batch's. `num_foreground` is
    this rank's share of the global count, so that the ranks' metrics add
    up to it."""
    num_classes = model_cfg["num_classes"]
    logits = preds["logits"]
    dev = logits.device
    strides = torch.tensor(model_cfg["fpn_strides"], dtype=torch.float32, device=dev)
    soi = torch.tensor(model_cfg.get("sizes_of_interest", SIZES_OF_INTEREST),
                       dtype=torch.float32, device=dev)
    shifts, lvl = all_shifts(preds["shapes"], model_cfg["fpn_strides"], dev)
    cls_t, reg_t, ctr_t = fcos_targets(
        shifts, lvl, strides, soi, batch["gt_boxes2d"], batch["gt_classes2d"].long(),
        batch["gt_mask2d"], num_classes=num_classes,
        center_sampling_radius=model_cfg.get("center_sampling_radius", 1.5))

    fg = cls_t < num_classes
    num_fg = torch.clamp(ddp.global_sum(fg.sum().float()), min=1.0)
    loss_cls = sigmoid_focal_loss(logits, one_hot_fg(cls_t, fg, num_classes)).sum() / num_fg

    giou = _giou_ltrb(preds["deltas"], reg_t)
    fgf = fg.float()
    num_tgt = torch.clamp(ddp.global_sum((ctr_t * fgf).sum()), min=1.0)
    loss_box = ((1 - giou) * ctr_t * fgf).sum() / num_tgt

    ctr_logits = preds["centerness"][..., 0]
    bce = (torch.clamp(ctr_logits, min=0) - ctr_logits * ctr_t
           + torch.log1p(torch.exp(-torch.abs(ctr_logits))))
    loss_ctr = (bce * fgf).sum() / num_fg

    return dict(loss_cls=loss_cls, loss_box_reg=loss_box, loss_centerness=loss_ctr,
                loss=loss_cls + loss_box + loss_ctr,
                num_foreground=num_fg / comm.get_world_size())


def nms_per_image(scores_all, boxes, *, score_threshold, nms_threshold, pre_max, post_max):
    """Best class per position, the score threshold, class-aware NMS:
    scores_all [B, R, C], boxes [B, R, 4] → efg_tpu's fixed-shape
    detections {boxes [B, P, 4], scores, labels (−1 where invalid), valid}."""
    scores = scores_all.amax(dim=-1)
    labels = scores_all.argmax(dim=-1)  # the first best class, as jnp.argmax
    masked = torch.where(scores > score_threshold, scores, torch.full_like(scores, NEG_INF))
    idx, valid = batched_nms(boxes, masked, labels, iou_threshold=nms_threshold,
                             pre_max=pre_max, post_max=post_max)
    sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    return dict(
        boxes=sel_boxes * valid[..., None],
        scores=torch.where(valid, torch.gather(scores, 1, idx), 0.0),
        labels=torch.where(valid, torch.gather(labels, 1, idx), -1),
        valid=valid,
    )


def decode(preds, *, model_cfg):
    """(scores [B, R, C] = √(σ(cls)·σ(ctr)), boxes [B, R, 4] xyxy)."""
    shifts, _ = all_shifts(preds["shapes"], model_cfg["fpn_strides"], preds["logits"].device)
    scores_all = torch.sqrt(torch.sigmoid(preds["logits"]) * torch.sigmoid(preds["centerness"]))
    d = preds["deltas"]
    sx, sy = shifts[None, :, 0], shifts[None, :, 1]
    boxes = torch.stack([sx - d[..., 0], sy - d[..., 1], sx + d[..., 2], sy + d[..., 3]], dim=-1)
    return scores_all, boxes


def predict(preds, *, model_cfg, score_threshold=0.05, nms_threshold=0.6,
            pre_max=1000, post_max=100):
    """Decode and class-aware NMS (efg_tpu's `predict`)."""
    scores_all, boxes = decode(preds, model_cfg=model_cfg)
    return nms_per_image(scores_all, boxes, score_threshold=score_threshold,
                         nms_threshold=nms_threshold, pre_max=pre_max, post_max=post_max)


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the FCOS experiments' `net.py` (the synthetic
    and the COCO one are one body): `model.fcos` of the config."""
    mc = config.model.fcos
    cfg = dict(num_classes=int(mc.num_classes), fpn_strides=list(mc.fpn_strides),
               center_sampling_radius=float(mc.get("center_sampling_radius", 1.5)))
    module = FCOS(num_classes=cfg["num_classes"], depth=int(mc.depth),
                  fpn_strides=tuple(cfg["fpn_strides"]), freeze_at=int(mc.get("freeze_at", 2)),
                  device=device, generator=generator)
    return ModelDef(
        module, lambda batch: dict(images=batch["images"]),
        lambda preds, batch: compute_loss(preds, batch, model_cfg=cfg),
        lambda preds, batch: predict(preds, model_cfg=cfg,
                                     score_threshold=float(mc.get("score_threshold", 0.05)),
                                     nms_threshold=float(mc.get("nms_threshold", 0.6))))
