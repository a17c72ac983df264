"""CenterPoint detectors (port of `efg_tpu/models/centerpoint.py`).
VoxelNet: points → on-device voxelization and mean VFE → SpMiddleResNetFHD
sparse trunk → BEV → RPN → CenterHead. PillarNet: points →
PillarFeatureNet → scatter onto the BEV canvas → RPN → CenterHead.
`compute_loss` assigns targets and computes the losses for training;
`predict` decodes the head maps and runs rotated NMS per task.

The module trains in `train()` mode (batch statistics, running-stat
updates: efg_tpu's `train=True, mutable=["batch_stats"]`) and serves in
`eval()` mode.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.modeling.backbones.rpn import RPN
from efg_tpu_torch.modeling.backbones.sparse_net import SpMiddleResNetFHD
from efg_tpu_torch.modeling.heads.center_head import (
    CenterHead,
    center_head_loss,
    centerpoint_targets,
    decode_boxes,
    post_process_sample,
)
from efg_tpu_torch.modeling.readers.voxel_reader import (
    PillarFeatureNet,
    dynamic_mean_vfe,
    pillar_scatter,
)
from efg_tpu_torch.ops.voxelize import grid_size


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Asking for a card that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


class VoxelNet(nn.Module):
    """CenterPoint with the SpMiddleResNetFHD sparse trunk (Waymo flagship).
    Parameters are created on `device` (default: the card); their initial
    values are drawn on the CPU from `generator` (None: torch's global
    RNG)."""

    def __init__(
        self,
        pc_range: Tuple[float, ...] = (-75.2, -75.2, -2.0, 75.2, 75.2, 4.0),
        voxel_size: Tuple[float, ...] = (0.1, 0.1, 0.15),
        max_voxels: int = 120000,
        num_input_features: int = 5,
        stage_caps: Sequence[int] = (70000, 45000, 25000, 20000),
        tasks: Sequence[Dict[str, Any]] = (
            {"num_classes": 3, "class_names": ["VEHICLE", "PEDESTRIAN", "CYCLIST"]},
        ),
        common_heads: Any = (("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)), ("rot", (2, 2))),
        neck_cfg: Any = (),
        act_dtype: str = "",
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.max_voxels = max_voxels
        self.num_input_features = num_input_features
        self.backbone = SpMiddleResNetFHD(
            num_input_features=num_input_features,
            grid_size=grid_size(pc_range, voxel_size),
            stage_caps=tuple(stage_caps),
            act_dtype=act_dtype,
            generator=generator,
        )
        self.neck = RPN(self.backbone.num_bev_channels, **dict(neck_cfg), generator=generator)
        self.head = CenterHead(self.neck.num_channels, tasks, dict(common_heads),
                               generator=generator)
        self.to(device)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        feats, coords, valid = dynamic_mean_vfe(
            points, points_mask,
            pc_range=self.pc_range, voxel_size=self.voxel_size,
            max_voxels=self.max_voxels, num_input_features=self.num_input_features,
        )
        bev = self.backbone(feats.detach(), coords, valid)  # efg_tpu's stop_gradient
        return self.head(self.neck(bev))


class PillarNet(nn.Module):
    """CenterPoint-Pillar: PillarFeatureNet + scatter + RPN + CenterHead.
    Parameters are created on `device`, drawn on the CPU from
    `generator`."""

    def __init__(
        self,
        pc_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        voxel_size: Tuple[float, ...] = (0.2, 0.2, 8.0),
        max_pillars: int = 30000,
        num_input_features: int = 5,
        pfn_filters: Sequence[int] = (64,),
        tasks: Sequence[Dict[str, Any]] = ({"num_classes": 1, "class_names": ["car"]},),
        common_heads: Any = (("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)),
                             ("rot", (2, 2)), ("vel", (2, 2))),
        neck_cfg: Any = (),
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.nx, self.ny, _ = grid_size(pc_range, voxel_size)
        self.reader = PillarFeatureNet(
            num_filters=tuple(pfn_filters), num_input_features=num_input_features,
            pc_range=pc_range, voxel_size=voxel_size, max_pillars=max_pillars,
            generator=generator)
        self.neck = RPN(tuple(pfn_filters)[-1], **dict(neck_cfg), generator=generator)
        self.head = CenterHead(self.neck.num_channels, tasks, dict(common_heads),
                               generator=generator)
        self.to(device)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        pf, coords_yx, valid = self.reader(points, points_mask)
        bev = pillar_scatter(pf, coords_yx, valid, ny=self.ny, nx=self.nx)
        return self.head(self.neck(bev))


def compute_loss(
    preds: List[Dict[str, torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    *,
    model_cfg: Dict[str, Any],
) -> Dict[str, torch.Tensor]:
    """batch needs gt_boxes [B, G, 9], gt_classes [B, G], gt_mask [B, G].
    `loss` sums the `*_loss` keys that are neither hm nor loc parts."""
    lc = model_cfg["loss"]
    with_vel = "vel" in dict(model_cfg["common_heads"])
    h, w = preds[0]["hm"].shape[1:3]
    targets = centerpoint_targets(
        batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
        tasks=model_cfg["tasks"],
        feature_map_size=(w, h),
        pc_range=model_cfg["pc_range"],
        voxel_size=model_cfg["voxel_size"],
        out_size_factor=lc["out_size_factor"],
        gaussian_overlap=lc["gaussian_overlap"],
        min_radius=lc["min_radius"],
        with_vel=with_vel,
    )
    losses = center_head_loss(preds, targets, code_weights=lc["code_weights"],
                              weight=lc["weight"], with_vel=with_vel)
    losses["loss"] = sum(v for k, v in losses.items()
                         if k.endswith("_loss") and "hm" not in k and "loc" not in k)
    return losses


def forward_double_flip(module: nn.Module, points: torch.Tensor,
                        points_mask: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """Double-flip test-time augmentation (efg_tpu's `forward_double_flip`):
    the model in eval mode on the cloud and on its y-, x- and xy-flipped
    copies, each prediction map un-flipped and the four averaged. Maps are
    [B, H(y), W(x), C]; on a flipped axis the sub-pixel offset `reg`
    mirrors to 1 − off, `rot` (sin, cos) negates sin for a y-flip and cos
    for an x-flip, and `vel` negates the flipped component. Returns the
    averaged per-task pred dicts."""
    module.eval()
    variants = ((False, False), (True, False), (False, True), (True, True))
    sign = {False: 1.0, True: -1.0}
    all_preds = []
    for fy, fx in variants:
        scale = points.new_tensor([sign[fx], sign[fy]] + [1.0] * (points.shape[-1] - 2))
        all_preds.append(module(points * scale, points_mask))

    def unflip(key, a, fy, fx):
        dims = [d for d, f in ((1, fy), (2, fx)) if f]
        if dims:
            a = torch.flip(a, dims)
        if key == "reg":  # (x, y) offsets
            a = torch.cat([1.0 - a[..., 0:1] if fx else a[..., 0:1],
                           1.0 - a[..., 1:2] if fy else a[..., 1:2]], dim=-1)
        elif key == "rot":  # (sin, cos): y → −y is θ → −θ, x → −x is θ → π − θ
            a = torch.cat([-a[..., 0:1] if fy else a[..., 0:1],
                           -a[..., 1:2] if fx else a[..., 1:2]], dim=-1)
        elif key == "vel":
            a = torch.cat([-a[..., 0:1] if fx else a[..., 0:1],
                           -a[..., 1:2] if fy else a[..., 1:2]], dim=-1)
        return a

    merged = []
    for t in range(len(all_preds[0])):
        merged.append({key: sum(unflip(key, preds[t][key], fy, fx)
                                for (fy, fx), preds in zip(variants, all_preds)) / len(variants)
                       for key in all_preds[0][t]})
    return merged


def predict(
    preds: List[Dict[str, torch.Tensor]],
    *,
    post_cfg: Dict[str, Any],
    model_cfg: Dict[str, Any],
) -> Dict[str, torch.Tensor]:
    """Decode + NMS every task, merge results: fixed-size [B, T·post_max]
    detections; labels are 1-based global class ids (0 = no detection)."""
    with_vel = "vel" in dict(model_cfg["common_heads"])
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    offset = 0
    for task_id, pred in enumerate(preds):
        boxes, scores = decode_boxes(
            pred,
            pc_range=model_cfg["pc_range"],
            voxel_size=model_cfg["voxel_size"],
            out_size_factor=post_cfg["out_size_factor"],
            with_vel=with_vel,
        )
        res = post_process_sample(
            boxes, scores,
            score_threshold=post_cfg["score_threshold"],
            post_center_range=post_cfg["post_center_limit_range"],
            nms_iou_threshold=post_cfg["nms"]["nms_iou_threshold"],
            nms_pre_max_size=post_cfg["nms"]["nms_pre_max_size"],
            nms_post_max_size=post_cfg["nms"]["nms_post_max_size"],
        )
        all_boxes.append(res["box3d"])
        all_scores.append(res["scores"])
        all_labels.append(torch.where(res["valid"], res["labels"] + 1 + offset, 0))
        all_valid.append(res["valid"])
        offset += int(model_cfg["tasks"][task_id]["num_classes"])
    return dict(
        box3d=torch.cat(all_boxes, dim=1),
        scores=torch.cat(all_scores, dim=1),
        labels=torch.cat(all_labels, dim=1),
        valid=torch.cat(all_valid, dim=1),
    )


def _model_cfg(config):
    m = config.model
    return dict(
        pc_range=tuple(config.dataset.pc_range),
        voxel_size=tuple(config.dataset.voxel_size),
        tasks=[dict(t) for t in m.head.tasks],
        common_heads=tuple((k, tuple(v)) for k, v in m.head.common_heads.items()),
        loss=dict(m.loss),
    )


def _model_def(config, module, cfg) -> ModelDef:
    def apply_args(batch):
        return dict(points=batch["points"], points_mask=batch["points_mask"])

    def loss_fn(preds, batch):
        return compute_loss(preds, batch, model_cfg=cfg)

    def predict_fn(preds, batch):
        return predict(preds, post_cfg=dict(config.model.post_process), model_cfg=cfg)

    return ModelDef(module, apply_args, loss_fn, predict_fn)


def _neck_cfg(config):
    return tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in config.model.neck.items())


def build_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the CenterPoint VoxelNet experiments' `net.py`
    (efg_tpu's synthetic, Waymo and nuScenes ones are one body): the model
    from the experiment's config, as a ModelDef on `device`, its initial
    weights drawn from `generator`."""
    cfg = _model_cfg(config)
    module = VoxelNet(
        pc_range=cfg["pc_range"],
        voxel_size=cfg["voxel_size"],
        max_voxels=int(config.model.max_voxels),
        num_input_features=int(config.model.reader.num_input_features),
        stage_caps=tuple(config.model.stage_caps),
        act_dtype=str(config.model.get("act_dtype", "")),
        tasks=tuple(cfg["tasks"]),
        common_heads=cfg["common_heads"],
        neck_cfg=_neck_cfg(config),
        device=device,
        generator=generator,
    )
    return _model_def(config, module, cfg)


def build_pillar_model(config, device="cuda", generator=None) -> ModelDef:
    """The `build_model` of the CenterPoint-Pillar experiment's `net.py`."""
    m = config.model
    cfg = _model_cfg(config)
    module = PillarNet(
        pc_range=cfg["pc_range"],
        voxel_size=cfg["voxel_size"],
        max_pillars=int(m.max_pillars),
        num_input_features=int(m.reader.num_input_features),
        pfn_filters=tuple(m.reader.pfn_filters),
        tasks=tuple(cfg["tasks"]),
        common_heads=cfg["common_heads"],
        neck_cfg=_neck_cfg(config),
        device=device,
        generator=generator,
    )
    return _model_def(config, module, cfg)
