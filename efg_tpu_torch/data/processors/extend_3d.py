"""3D point-cloud processors (host-side numpy): a copy of the processors
of `efg_tpu/data/processors/extend_3d.py` that the synthetic experiment
names, with the same registry names and YAML kwargs. Each draws from
numpy's global RNG exactly as efg_tpu's does, so per-item seeding
(`DataLoader._seed_for`) gives the same augmentations bit for bit.

The other processors of efg_tpu (GT-database sampling, drops, crops,
host voxelization) are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np

from efg_tpu_torch.data.processors.base import AugmentationBase
from efg_tpu_torch.data.registry import PROCESSORS
from efg_tpu_torch.geometry import box_ops_np as G


def _dict_select(d: dict, keep) -> None:
    for k, v in list(d.items()):
        if isinstance(v, np.ndarray) and v.shape[:1] == keep.shape[:1]:
            d[k] = v[keep]


@PROCESSORS.register()
class PointShuffle(AugmentationBase):
    def __init__(self, p=0.5):
        self._init(locals())

    def __call__(self, points, info):
        if self._rand_range() <= self.p:
            np.random.shuffle(points)
        return points, info


@PROCESSORS.register()
class RandomFlip3D(AugmentationBase):
    """Independent x- and y-axis flips with yaw/velocity fixups
    (reference `:120-168`)."""

    def __init__(self, p=0.5):
        self._init(locals())

    @staticmethod
    def _flip_y(boxes):  # y := -y
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, -1] = -boxes[:, -1]
        if boxes.shape[1] > 7:
            boxes[:, 7] = -boxes[:, 7]

    @staticmethod
    def _flip_x(boxes):  # x := -x
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, -1] = -(boxes[:, -1] + np.pi)
        if boxes.shape[1] > 7:
            boxes[:, 6] = -boxes[:, 6]

    def _apply(self, info, fn):
        if "annotations" in info:
            fn(info["annotations"]["gt_boxes"])
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    fn(sweep["annotations"]["gt_boxes"])

    def __call__(self, points, info):
        if np.random.random() < self.p:
            points[:, 1] = -points[:, 1]
            self._apply(info, self._flip_y)
        if np.random.random() < self.p:
            points[:, 0] = -points[:, 0]
            self._apply(info, self._flip_x)
        return points, info


@PROCESSORS.register()
class GlobalRotation(AugmentationBase):
    def __init__(self, rotation):
        if not isinstance(rotation, (list, tuple)):
            rotation = [-rotation, rotation]
        self._init(locals())

    def _rot(self, info, angle):
        boxes = info["annotations"]["gt_boxes"]
        boxes[:, :3] = G.rotate_points_along_z(boxes[None, :, :3], np.array([angle]))[0]
        boxes[:, -1] += angle
        if boxes.shape[1] > 7:
            vel3 = np.concatenate([boxes[:, 6:8], np.zeros((len(boxes), 1))], axis=1)
            boxes[:, 6:8] = G.rotate_points_along_z(vel3[None], np.array([angle]))[0, :, :2]

    def __call__(self, points, info):
        angle = np.random.uniform(self.rotation[0], self.rotation[1])
        points_rot = G.rotate_points_along_z(points[None], np.array([angle]))[0]
        points[:] = points_rot
        if "annotations" in info:
            self._rot(info, angle)
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    self._rot(sweep, angle)
        return points, info


@PROCESSORS.register()
class GlobalScaling(AugmentationBase):
    def __init__(self, min_scale, max_scale):
        self._init(locals())

    def __call__(self, points, info):
        s = np.random.uniform(self.min_scale, self.max_scale)
        points[:, :3] *= s
        if "annotations" in info:
            info["annotations"]["gt_boxes"][:, :-1] *= s
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    sweep["annotations"]["gt_boxes"][:, :-1] *= s
        return points, info


class _FilterBase(AugmentationBase):
    box_filter = staticmethod(G.mask_boxes_outside_range_bev_z_bound)

    def __init__(self, pc_range, with_gt=True, with_data=True):
        pc_range = np.asarray(list(pc_range))
        self._init(locals())

    def __call__(self, points, info):
        if self.with_data:
            points = points[G.mask_points_by_range(points, self.pc_range)]
        if self.with_gt and "annotations" in info:
            for tgt in [info] + list(info.get("sweeps", [])):
                if "annotations" in tgt:
                    keep = self.box_filter(tgt["annotations"]["gt_boxes"], self.pc_range)
                    _dict_select(tgt["annotations"], keep)
        return points, info


@PROCESSORS.register()
class FilterByRange(_FilterBase):
    """Reference `FilterByRange` (`extend_3d.py:286-315`)."""


@PROCESSORS.register()
class PadPoints(AugmentationBase):
    """Pad/truncate the cloud to a fixed [N, C] + validity mask: the
    fixed-shape batch the on-device voxelizer takes."""

    def __init__(self, num_points: int):
        self._init(locals())

    def __call__(self, points, info):
        n, c = points.shape
        out = np.zeros((self.num_points, c), dtype=np.float32)
        m = min(n, self.num_points)
        if n > self.num_points:
            sel = np.random.choice(n, self.num_points, replace=False)
            out[:] = points[sel]
        else:
            out[:m] = points
        mask = np.zeros(self.num_points, dtype=bool)
        mask[:m] = True
        return dict(points=out, points_mask=mask), info
