"""TrajectoryFormer: 3D multi-object tracking by trajectory hypotheses
(port of `efg_tpu/models/trajectoryformer.py`).

Per frame, each hypothesis box (a detection, or a track's motion-predicted
box) is encoded from (a) the points cropped around it by a PointNet and
(b) its track's box history by a motion encoder; a global-local
transformer mixes the hypotheses' features (global attention over all of
them, local attention within a track's group), and per-hypothesis heads
score it and refine its box. Every shape is fixed: N hypotheses a frame,
P points a hypothesis, T history steps, invalid slots masked. Parameter
names are the flax modules', so `utils/jax_import.py` maps efg_tpu's
variables onto the module one to one.

Every tensor carries a leading batch dimension here, where efg_tpu's core
takes one frame and its detection form vmaps it. `MotionPrediction` is
the pretrain regime; `load_motion_encoder` grafts its encoder into the
tracking model from the port's own checkpoint of that run.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.geometry import box_ops_torch as G3
from efg_tpu_torch.modeling.common.layers import FLAX_NORM_EPS, MultiHeadDotProductAttention, dense
from efg_tpu_torch.ops.iou_rotated import iou_bev

NEG = -1e9  # masked entries of a max-pool (efg_tpu's)


def _ln(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=FLAX_NORM_EPS)


def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over the valid entries of dim -2; 0 where none is valid."""
    pooled = torch.where(mask[..., None], x, torch.full_like(x, NEG)).amax(dim=-2)
    return torch.where(mask.any(-1, keepdim=True), pooled, torch.zeros_like(pooled))


class PointNet(nn.Module):
    """Per-hypothesis point encoder: pointwise MLP (64, 128, channels, each
    Dense → LayerNorm → ReLU) → masked max-pool → Dense."""

    def __init__(self, channels: int = 128, cin: int = 4, generator=None):
        super().__init__()
        dims = (cin, 64, 128, channels)
        for i in range(3):
            setattr(self, f"mlp{i}", dense(dims[i], dims[i + 1], generator=generator))
            setattr(self, f"ln{i}", _ln(dims[i + 1]))
        self.out = dense(channels, channels, generator=generator)

    def forward(self, pts, mask):
        """pts [..., P, C], mask [..., P] → [..., channels]."""
        x = pts
        for i in range(3):
            x = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"mlp{i}")(x)))
        return self.out(_masked_max(x, mask))


class MotionEncoder(nn.Module):
    """Trajectory (history boxes) encoder: per-step MLP (64, 128) → max over
    the valid steps → Dense."""

    def __init__(self, channels: int = 128, cin: int = 8, generator=None):
        super().__init__()
        dims = (cin, 64, 128)
        for i in range(2):
            setattr(self, f"mlp{i}", dense(dims[i], dims[i + 1], generator=generator))
            setattr(self, f"ln{i}", _ln(dims[i + 1]))
        self.out = dense(128, channels, generator=generator)

    def forward(self, traj, mask):
        """traj [..., T, D] box history (current-relative), mask [..., T] → [..., C]."""
        x = traj
        for i in range(2):
            x = torch.relu(getattr(self, f"ln{i}")(getattr(self, f"mlp{i}")(x)))
        return self.out(_masked_max(x, mask))


class GlobalLocalLayer(nn.Module):
    """Global attention over every hypothesis, local attention within a
    track's group (`group_mask`), FFN; each with a residual and LayerNorm.
    A hypothesis whose `group_mask` row is all False attends uniformly, as
    flax's finite mask value gives it, instead of reading NaN."""

    def __init__(self, d_model: int = 256, nhead: int = 4, dim_feedforward: int = 512,
                 generator=None):
        super().__init__()
        self.global_attn = MultiHeadDotProductAttention(d_model, nhead, generator=generator)
        self.local_attn = MultiHeadDotProductAttention(d_model, nhead, generator=generator)
        self.norm1, self.norm2, self.norm3 = _ln(d_model), _ln(d_model), _ln(d_model)
        self.linear1 = dense(d_model, dim_feedforward, generator=generator)
        self.linear2 = dense(dim_feedforward, d_model, generator=generator)

    def forward(self, x, group_mask):
        """x [B, N, C]; group_mask [B, N, N], True = same track group."""
        x = self.norm1(x + self.global_attn(x, x, x))
        x = self.norm2(x + self.local_attn(x, x, x, mask=group_mask[:, None]))
        return self.norm3(x + self.linear2(torch.relu(self.linear1(x))))


class TrajectoryFormer(nn.Module):
    """Hypothesis scorer / refiner on pre-cropped fixed-shape inputs."""

    def __init__(self, d_model: int = 256, num_layers: int = 3, num_points: int = 128,
                 history: int = 10, generator=None):
        super().__init__()
        self.num_layers, self.num_points, self.history = num_layers, num_points, history
        self.point_encoder = PointNet(128, generator=generator)
        self.motion_encoder = MotionEncoder(128, generator=generator)
        self.box_embed = dense(7, 64, generator=generator)
        self.fuse = dense(128 + 128 + 64, d_model, generator=generator)
        for i in range(num_layers):
            setattr(self, f"layer{i}", GlobalLocalLayer(d_model, generator=generator))
        self.cls_head = dense(d_model, 1, generator=generator)
        self.reg_head = dense(d_model, 7, kernel="zeros", generator=generator)

    def forward(self, hyp_points, hyp_pts_mask, hyp_traj, hyp_traj_mask, hyp_boxes, group_ids,
                valid) -> Dict[str, torch.Tensor]:
        """hyp_points [B, N, P, 4] (box-frame xyz + intensity), hyp_pts_mask
        [B, N, P], hyp_traj [B, N, T, 8] (history boxes relative to the
        current one: xyz, lwh, sin/cos yaw), hyp_traj_mask [B, N, T],
        hyp_boxes [B, N, 7], group_ids [B, N] (one id a track group),
        valid [B, N] → scores [B, N] (logits), refine [B, N, 7], features."""
        pt = self.point_encoder(hyp_points, hyp_pts_mask)
        mo = self.motion_encoder(hyp_traj, hyp_traj_mask)
        x = torch.relu(self.fuse(torch.cat([pt, mo, self.box_embed(hyp_boxes)], dim=-1)))
        group_mask = ((group_ids[:, :, None] == group_ids[:, None, :])
                      & valid[:, :, None] & valid[:, None, :])
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, group_mask)
        return dict(scores=self.cls_head(x)[..., 0], refine=self.reg_head(x), features=x)


# ---------------------------------------------------------------------------
# Hypothesis points (device, fixed shapes)
# ---------------------------------------------------------------------------


def crop_hypothesis_points(points: torch.Tensor, points_mask: torch.Tensor, boxes: torch.Tensor,
                           *, num_points: int, margin: float = 0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, Np, 4+], points_mask [B, Np], boxes [B, N, 7] → the first
    `num_points` valid points inside each box grown by `margin`, by point
    index, in the box frame (x, y turned by −yaw, z, intensity) [B, N, P,
    4], and their mask [B, N, P]. A point's rank among a box's inside
    points is its cumsum (efg_tpu's), and it lands in that slot directly
    where efg_tpu sorts each box's indices: the same indices. The masks
    lie [B, N, Np], so that the cumsum runs along the last dimension (along
    the points of a [B, Np, N] layout, CUDA scans the N columns one point
    after another). A point not taken lands in a slot of its own past the
    first P, so that no two writes share an address."""
    b, n_pts = points.shape[:2]
    n = boxes.shape[1]
    inside = torch.stack([G3.points_in_rbbox(points[i, :, :3], boxes[i], margin=margin).T
                          for i in range(b)]) & points_mask[:, None, :]  # [B, N, Np]
    rank = torch.cumsum(inside.to(torch.int32), dim=2) - 1
    take = inside & (rank < num_points)
    src = torch.arange(n_pts, device=points.device)
    slot = torch.where(take, rank, num_points + src.to(torch.int32))
    idx = torch.full((b, n, num_points + n_pts), n_pts, dtype=torch.long, device=points.device)
    idx.scatter_(2, slot.long(), src.expand(b, n, n_pts))
    idx = idx[..., :num_points]
    ok = idx < n_pts
    p = torch.gather(points, 1, idx.clamp(max=n_pts - 1).reshape(b, n * num_points, 1)
                     .expand(-1, -1, points.shape[-1])).reshape(b, n, num_points, -1)
    local = p[..., :3] - boxes[:, :, None, :3]
    c, s = torch.cos(boxes[..., 6])[..., None], torch.sin(boxes[..., 6])[..., None]
    lx = local[..., 0] * c + local[..., 1] * s
    ly = -local[..., 0] * s + local[..., 1] * c
    feats = torch.stack([lx, ly, local[..., 2], p[..., 3]], dim=-1)
    return feats * ok[..., None], ok


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    n = diff.abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """ResidualCoder encode: centre offsets over the BEV diagonal (z over
    the height), log dims, yaw delta."""
    xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
    xg, yg, zg, dxg, dyg, dzg, rg = gt[..., :7].unbind(-1)
    dxa, dya, dza = dxa.clamp(min=1e-3), dya.clamp(min=1e-3), dza.clamp(min=1e-3)
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                        torch.log(dxg.clamp(min=1e-3) / dxa), torch.log(dyg.clamp(min=1e-3) / dya),
                        torch.log(dzg.clamp(min=1e-3) / dza), rg - ra], dim=-1)


def decode_boxes(enc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
    xt, yt, zt, dxt, dyt, dzt, rt = enc[..., :7].unbind(-1)
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    return torch.stack([xt * diag + xa, yt * diag + ya, zt * dza + za, torch.exp(dxt) * dxa,
                        torch.exp(dyt) * dya, torch.exp(dzt) * dza, rt + ra], dim=-1)


def corner_loss_lidar(pred7: torch.Tensor, gt7: torch.Tensor) -> torch.Tensor:
    """[..., 7] × [..., 7] → [...]: each corner's distance to the GT's (the
    nearer of the GT and the GT turned by π), smooth-L1 at beta 1, mean
    over the 8 corners."""
    pc = G3.boxes_to_corners_3d(pred7)
    gc = G3.boxes_to_corners_3d(gt7)
    gt_flip = torch.cat([gt7[..., :6], gt7[..., 6:7] + math.pi], dim=-1)
    gcf = G3.boxes_to_corners_3d(gt_flip)
    d = torch.minimum(torch.linalg.norm(pc - gc, dim=-1), torch.linalg.norm(pc - gcf, dim=-1))
    return smooth_l1(d, 1.0).mean(dim=-1)


def _decode_in_roi(reg: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """Decode a refinement in the roi-local frame (anchors at the origin),
    turn its centre by the roi's yaw and move it to the roi's centre."""
    anchors0 = torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:7]], dim=-1)
    local = decode_boxes(reg[..., :7], anchors0)
    rot = G3.rotate_points_along_z(local[..., None, :], rois[..., 6])[..., 0, :]
    return torch.cat([rot[..., :3] + rois[..., :3], rot[..., 3:]], dim=-1)


def corner_loss(point_reg: torch.Tensor, rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[..., N] corner loss of the decoded refinement against `gt`."""
    return corner_loss_lidar(_decode_in_roi(point_reg, rois), gt[..., :7])


def apply_refinement(hyp_boxes: torch.Tensor, refine: torch.Tensor) -> torch.Tensor:
    """The refined boxes [..., 7]: the refinement decoded as the corner
    loss decodes it."""
    return _decode_in_roi(refine, hyp_boxes[..., :7])


def compute_loss(outputs: Dict[str, torch.Tensor], hyp_boxes, gt_boxes, gt_mask, valid, *,
                 iou_lo: float = 0.3, iou_hi: float = 0.7) -> Dict[str, torch.Tensor]:
    """One frame's loss (efg_tpu's `compute_loss`): the confidence target
    is the best BEV IoU against the GT clipped to [iou_lo, iou_hi] and
    scaled to [0, 1] (BCE over the valid hypotheses); hypotheses above
    iou_hi regress their matched GT (smooth-L1 at beta 1/9 on the
    ResidualCoder encoding, plus the decoded corner loss)."""
    iou = iou_bev(hyp_boxes, gt_boxes)  # [N, G]
    iou = torch.where(gt_mask[None, :], iou, torch.full_like(iou, -1.0))
    best, match = iou.max(dim=1).values, iou.argmax(dim=1)
    cls_tgt = ((best - iou_lo) / (iou_hi - iou_lo)).clamp(0.0, 1.0)

    logits = outputs["scores"]
    bce = logits.clamp(min=0) - logits * cls_tgt + torch.log1p(torch.exp(-logits.abs()))
    vf = valid.to(logits.dtype)
    loss_cls = (bce * vf).sum() / vf.sum().clamp(min=1.0)

    matched_gt = gt_boxes[match]
    residual = encode_boxes(matched_gt[:, :7], hyp_boxes[:, :7])
    pos = (best > iou_hi) & valid
    pf = pos.to(logits.dtype)
    n_pos = pf.sum().clamp(min=1.0)
    per = smooth_l1(outputs["refine"] - residual, 1.0 / 9.0)
    loss_reg = (per * pf[:, None]).sum() / n_pos
    loss_corner = (corner_loss(outputs["refine"], hyp_boxes[:, :7], matched_gt[:, :7])
                   * pf).sum() / n_pos
    loss_reg = loss_reg + loss_corner
    return dict(loss_cls=loss_cls, loss_reg=loss_reg, loss=loss_cls + loss_reg,
                num_pos=pos.sum().to(logits.dtype))


# ---------------------------------------------------------------------------
# The batched detection form (the experiments' training model)
# ---------------------------------------------------------------------------


def _boxes7(boxes9: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes9[..., :6], boxes9[..., -1:]], dim=-1)


class TrajectoryFormerDet(nn.Module):
    """Crops the points around each frame's detection boxes and scores /
    refines them with the core (no history: each detection its own
    group)."""

    def __init__(self, d_model: int = 256, num_layers: int = 3, num_points: int = 128,
                 history: int = 10, device="cuda", generator=None):
        super().__init__()
        self.num_points, self.history = num_points, history
        self.core = TrajectoryFormer(d_model, num_layers, num_points, history, generator=generator)
        self.to(device)

    def forward(self, points, points_mask, det_boxes, det_mask):
        """points [B, Np, C], det_boxes [B, N, 7+] (yaw last), det_mask [B, N]."""
        b, n = det_boxes.shape[:2]
        boxes7 = _boxes7(det_boxes)
        hp, hm = crop_hypothesis_points(points, points_mask, boxes7, num_points=self.num_points)
        traj = points.new_zeros((b, n, self.history, 8))
        traj_mask = torch.zeros((b, n, self.history), dtype=torch.bool, device=points.device)
        groups = torch.arange(n, device=points.device).expand(b, n)
        return self.core(hp, hm, traj, traj_mask, boxes7, groups, det_mask)


def det_compute_loss(outputs, batch) -> Dict[str, torch.Tensor]:
    """Each frame's `compute_loss`, averaged over the batch."""
    det7, gt7 = _boxes7(batch["det_boxes"]), _boxes7(batch["gt_boxes"])
    per = [compute_loss({k: v[i] for k, v in outputs.items()}, det7[i], gt7[i],
                        batch["gt_mask"][i], batch["det_mask"][i]) for i in range(det7.shape[0])]
    return {k: torch.stack([p[k] for p in per]).mean() for k in per[0]}


def det_predict(outputs, batch) -> Dict[str, torch.Tensor]:
    """Refined, rescored detections for the tracking evaluator. A
    detection keeps its own class (`det_labels`, carried by the collate),
    where efg_tpu takes the class of the GT in the same slot: on Waymo
    the two differ (ROADMAP queue 3)."""
    det = batch["det_boxes"]
    refined = apply_refinement(_boxes7(det), outputs["refine"])
    mask = batch["det_mask"]
    boxes9 = torch.cat([refined[..., :6], det[..., 6:8], refined[..., 6:7]], dim=-1)
    return dict(box3d=boxes9, scores=torch.sigmoid(outputs["scores"]) * mask,
                labels=torch.where(mask, batch["det_labels"], torch.zeros_like(batch["det_labels"])),
                valid=mask)


# ---------------------------------------------------------------------------
# Motion-prediction pretraining and the graft
# ---------------------------------------------------------------------------


class MotionPrediction(nn.Module):
    """Encodes each object's history and predicts its future centre
    offsets. Its encoder is named `motion_encoder`, so its weights graft
    into `TrajectoryFormerDet.core.motion_encoder`."""

    def __init__(self, d_model: int = 128, num_future: int = 10, device="cuda", generator=None):
        super().__init__()
        self.num_future = num_future
        self.motion_encoder = MotionEncoder(d_model, generator=generator)
        self.future_head = dense(d_model, num_future * 3, kernel="zeros", generator=generator)
        self.to(device)

    def forward(self, traj, traj_mask):
        """traj [B, N, T, 8], traj_mask [B, N, T] → future offsets [B, N, F, 3]."""
        b, n = traj.shape[:2]
        out = self.future_head(torch.relu(self.motion_encoder(traj, traj_mask)))
        return out.reshape(b, n, self.num_future, 3)


def motion_compute_loss(pred_future, batch) -> Dict[str, torch.Tensor]:
    """Smooth-L1 (beta 1) on the future centre offsets over the valid
    (object, step) slots."""
    diff = pred_future - batch["future_offsets"]
    ad = diff.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
    mf = batch["future_mask"][..., None].to(sl1.dtype)
    loss = (sl1 * mf).sum() / (mf.sum() * 3).clamp(min=1.0)
    return dict(loss=loss, loss_motion=loss)


def motion_predict(pred_future, batch) -> Dict[str, torch.Tensor]:
    """Fixed-shape empty detections, so that the evaluation loop runs."""
    b, n = pred_future.shape[:2]
    dev = pred_future.device
    return dict(box3d=pred_future.new_zeros((b, n, 9)), scores=pred_future.new_zeros((b, n)),
                labels=torch.zeros((b, n), dtype=torch.int32, device=dev),
                valid=torch.zeros((b, n), dtype=torch.bool, device=dev))


def resolve_motion_model(path: str) -> str:
    """The pretrain checkpoint a config's `model.motion_model` names. A
    relative path is taken from the working directory, as efg_tpu takes it
    (efg_run runs in the experiment's directory); a `log` component, the
    link efg_run makes to its output, reads as `log_torch`, the port's
    link (`cli/main.py` `setup_output_dir`)."""
    parts = ["log_torch" if p == "log" else p for p in str(path).split(os.sep)]
    return os.path.abspath(os.sep.join(parts))


MOTION_PREFIX = "motion_encoder."
GRAFT_PREFIX = "core.motion_encoder."


def load_motion_encoder(module: nn.Module, ckpt_path: str) -> Dict[str, torch.Tensor]:
    """Copy the `motion_encoder.*` weights of a motion-pretrain checkpoint
    written by the port's trainer into `module`'s `core.motion_encoder.*`,
    strictly: every encoder tensor of the checkpoint is used once, every
    tensor of the target is filled, each with its own shape. Returns the
    grafted tensors by their name in `module`."""
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)["model"]
    src = {k[len(MOTION_PREFIX):]: v for k, v in state.items() if k.startswith(MOTION_PREFIX)}
    dst = {k[len(GRAFT_PREFIX):]: v for k, v in module.state_dict().items()
           if k.startswith(GRAFT_PREFIX)}
    if set(src) != set(dst):
        raise KeyError(f"{ckpt_path}: motion encoder tensors {sorted(src)} do not match the "
                       f"model's {sorted(dst)}")
    grafted = {}
    with torch.no_grad():
        for k, t in dst.items():
            if tuple(src[k].shape) != tuple(t.shape):
                raise ValueError(f"{ckpt_path}: {MOTION_PREFIX}{k} has shape "
                                 f"{tuple(src[k].shape)}, the model's {tuple(t.shape)}")
            t.copy_(src[k])
            grafted[GRAFT_PREFIX + k] = t
    return grafted


# ---------------------------------------------------------------------------
# The experiments' config → model (efg_tpu's tracking `net.py` files)
# ---------------------------------------------------------------------------


def build_model(config, device="cuda", generator: Optional[torch.Generator] = None):
    """The TrajectoryFormer experiments' `build_model`, on `device`: the
    detection form, its losses and predictions, and, when the config names
    `model.motion_model`, the graft of that pretrain checkpoint's encoder
    as the ModelDef's `init_params`."""
    mc = config.model.trajectoryformer
    module = TrajectoryFormerDet(int(mc.d_model), int(mc.num_layers), int(mc.num_points),
                                 int(mc.history), device=device, generator=generator)

    def apply_args(batch):
        return dict(points=batch["points"], points_mask=batch["points_mask"],
                    det_boxes=batch["det_boxes"], det_mask=batch["det_mask"])

    init_params = None
    motion_ckpt = config.model.get("motion_model", "")
    if motion_ckpt:
        path = resolve_motion_model(str(motion_ckpt))

        def init_params(m):
            load_motion_encoder(m, path)

    return ModelDef(module, apply_args, det_compute_loss, det_predict, init_params=init_params)


def build_pretrain_model(config, device="cuda", generator: Optional[torch.Generator] = None):
    """The motion-pretrain experiments' `build_model`, on `device`."""
    mc = config.model.motionpred
    module = MotionPrediction(int(mc.d_model), int(mc.num_future), device=device,
                              generator=generator)

    def apply_args(batch):
        return dict(traj=batch["traj_hist"], traj_mask=batch["traj_mask"])

    return ModelDef(module, apply_args, motion_compute_loss, motion_predict)
