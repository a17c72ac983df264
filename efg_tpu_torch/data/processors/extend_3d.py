"""3D point-cloud processors (host-side numpy): a copy of
`efg_tpu/data/processors/extend_3d.py`, all 17 processors, with the same
registry names and YAML kwargs. Each draws from numpy's global RNG in the
order efg_tpu's does, so per-item seeding (`DataLoader._seed_for`) gives
the same augmentations bit for bit. `DatabaseSampling` keeps state across
items (`data/samplers/gt_database_sampler.py`). The pipeline the loader
batches ends with `PadPoints`, whose fixed-shape `points [N, C]` + mask
the on-device voxelizer takes; `Voxelization` is efg_tpu's host
voxelizer (numpy path). The flips, the rotation, the scaling and the
translation also move an item's detection boxes (`info["detections"]`,
which only the port's `WaymoTrackingDataset` sets).
"""

from __future__ import annotations

import numpy as np

from efg_tpu_torch.data.processors.base import AugmentationBase
from efg_tpu_torch.data.registry import PROCESSORS
from efg_tpu_torch.data.samplers.gt_database_sampler import DataBaseSampler
from efg_tpu_torch.geometry import box_ops_np as G
from efg_tpu_torch.ops.voxelize_np import VoxelGenerator


def _det_boxes(info: dict):
    """The item's detection boxes that the geometric processors move with
    the points (`WaymoTrackingDataset` puts them under
    `info["detections"]` before the processors run; efg_tpu has none
    there), as a list of zero or one arrays, changed in place."""
    det = info.get("detections")
    return [det["det_boxes"]] if det is not None and len(det["det_boxes"]) else []


def _dict_select(d: dict, keep) -> None:
    for k, v in list(d.items()):
        if isinstance(v, np.ndarray) and v.shape[:1] == keep.shape[:1]:
            d[k] = v[keep]


@PROCESSORS.register()
class FilterByDifficulty(AugmentationBase):
    """Drop GT with difficulty in `filter_difficulties` (reference `:24-47`)."""

    def __init__(self, filter_difficulties):
        self._init(locals())

    def _filter(self, info):
        anno = info.get("annotations")
        if anno and "difficulty" in anno:
            keep = ~np.isin(anno["difficulty"], self.filter_difficulties)
            _dict_select(anno, keep)

    def __call__(self, points, info):
        if "annotations" in info:
            self._filter(info)
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    self._filter(sweep)
        return points, info


@PROCESSORS.register()
class DatabaseSampling(AugmentationBase):
    """GT-database copy-paste augmentation (reference `:49-93`)."""

    def __init__(self, db_info_path, sample_groups, min_points=0, difficulty=-1,
                 p=1.0, rm_points_after_sample=False):
        self.p = p
        self.rm_points_after_sample = rm_points_after_sample
        self.db_sampler = DataBaseSampler(
            db_info_path, sample_groups, min_points=min_points, difficulty=difficulty
        )

    def __call__(self, points, info):
        if self._rand_range() <= self.p:
            sampled = self.db_sampler.sample_all(
                info["metadata"]["db_path"],
                info["annotations"]["gt_boxes"],
                info["annotations"]["gt_names"],
                info["metadata"]["num_point_features"],
            )
            if sampled is not None:
                for k in ("gt_names", "gt_boxes"):
                    info["annotations"][k] = np.concatenate(
                        [info["annotations"][k], sampled[k]], axis=0
                    )
                for k in ("difficulty", "num_points_in_gt"):
                    if k in info["annotations"]:
                        info["annotations"][k] = np.concatenate(
                            [info["annotations"][k], sampled[k]], axis=0
                        )
                info["annotations"]["gt_boxes"] = np.nan_to_num(info["annotations"]["gt_boxes"])
                if self.rm_points_after_sample:
                    inside = G.points_in_rbbox(points, np.nan_to_num(sampled["gt_boxes"]))
                    points = points[~inside.any(-1)]
                points = np.nan_to_num(
                    np.concatenate([sampled["points"], points], axis=0)
                )
        return points, info


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
        for boxes in _det_boxes(info):
            fn(boxes)

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
        self._rot_boxes(info["annotations"]["gt_boxes"], angle)

    @staticmethod
    def _rot_boxes(boxes, angle):
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
        for boxes in _det_boxes(info):
            self._rot_boxes(boxes, angle)
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
        for boxes in _det_boxes(info):
            boxes[:, :-1] *= s
        return points, info


@PROCESSORS.register()
class GlobalTranslation(AugmentationBase):
    def __init__(self, std=(0, 0, 0)):
        self._init(locals())

    def __call__(self, points, info):
        t = np.random.normal(scale=np.asarray(self.std, np.float32), size=3)
        points[:, :3] += t
        if "annotations" in info:
            info["annotations"]["gt_boxes"][:, :3] += t
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    sweep["annotations"]["gt_boxes"][:, :3] += t
        for boxes in _det_boxes(info):
            boxes[:, :3] += t
        return points, info


@PROCESSORS.register()
class PointsJitter(AugmentationBase):
    def __init__(self, jitter_std=(0.01, 0.01, 0.01), clip_range=(-0.05, 0.05)):
        self._init(locals())

    def __call__(self, points, info):
        noise = np.random.randn(points.shape[0], 3) * np.asarray(self.jitter_std)[None]
        if self.clip_range is not None:
            noise = np.clip(noise, self.clip_range[0], self.clip_range[1])
        points[:, :3] += noise
        return points, info


@PROCESSORS.register()
class PointDrop(AugmentationBase):
    def __init__(self, p=0.1):
        self._init(locals())

    def __call__(self, points, info):
        keep = np.random.random(points.shape[0]) >= self.p
        return points[keep], info


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
class FilterByRangeCenter(_FilterBase):
    box_filter = staticmethod(G.mask_boxes_outside_range_center)


@PROCESSORS.register()
class FilterByRangeXY(_FilterBase):
    """BEV-xy-only GT filter (reference `extend_3d.py:328-331`): keeps a
    box when its center xy lies inside the range, ignoring z."""

    box_filter = staticmethod(G.mask_points_by_range_bev)


@PROCESSORS.register()
class GTDrop(AugmentationBase):
    """Randomly drop a sampled fraction of GT boxes AND the points inside
    them (reference `extend_3d.py:510-530`): ratio ~ U[ratio[0], ratio[1]],
    each box kept with prob 1-ratio; points inside dropped boxes removed."""

    def __init__(self, ratio=(0.0, 0.2)):
        self._init(locals())

    def __call__(self, points, info):
        assert "annotations" in info
        gt_boxes = info["annotations"]["gt_boxes"]
        ratio = np.random.uniform(self.ratio[0], self.ratio[1])
        keep = np.random.random(gt_boxes.shape[0]) >= ratio
        _dict_select(info["annotations"], keep)
        drop_boxes = gt_boxes[~keep]
        if len(drop_boxes):
            inside = G.points_in_rbbox(points, np.nan_to_num(drop_boxes))
            points = points[~inside.any(-1)]
        return points, info


@PROCESSORS.register()
class GTDropByCat(AugmentationBase):
    """Per-category GTDrop (reference `extend_3d.py:463-507`): category i
    drops with ratio ~ U[ratio[0], ratio[1][i]]; boxes of unlisted
    categories are dropped entirely (reference semantics: the kept mask is
    the union of per-category keeps)."""

    def __init__(self, ratio=(0.0, (0.2,) * 10),
                 categories=("car", "truck", "construction_vehicle", "bus",
                             "trailer", "barrier", "motorcycle", "bicycle",
                             "pedestrian", "traffic_cone")):
        self._init(locals())

    def __call__(self, points, info):
        assert "annotations" in info
        gt_boxes = info["annotations"]["gt_boxes"]
        gt_names = info["annotations"]["gt_names"]
        keep = np.zeros(gt_names.shape[0], dtype=bool)
        for cati, cat in enumerate(self.categories):
            cat_idx = np.nonzero(gt_names == cat)[0]
            cat_ratio = np.random.uniform(self.ratio[0], self.ratio[1][cati])
            cat_keep = np.random.random(cat_idx.shape[0]) >= cat_ratio
            keep[cat_idx[cat_keep]] = True
        _dict_select(info["annotations"], keep)
        drop_boxes = gt_boxes[~keep]
        if len(drop_boxes):
            inside = G.points_in_rbbox(points, np.nan_to_num(drop_boxes))
            points = points[~inside.any(-1)]
        return points, info


@PROCESSORS.register()
class RandomCropPoints(AugmentationBase):
    """BEV square crop + rescale to the original extent (reference
    `extend_3d.py:330-454`): sample a square crop window inside the BEV
    range, drop points/GT outside it, re-center, then scale x/y (and box
    dims/velocities) back up to the full range. Crop types follow the
    reference (which forces square crops): "relative" (h*ch),
    "relative_range" (ch ~ U[crop_size[0], 1]), "absolute" (min(cs, h)),
    "absolute_range" (ch ~ U[cs0, min(h, cs1)] — the reference's
    `np.random.rand(lo, hi)` call is a bug; the docstring semantics are
    implemented here)."""

    def __init__(self, crop_type, crop_size, pc_range, p=0.5):
        assert crop_type in ("relative_range", "relative", "absolute", "absolute_range")
        self._init(locals())

    def _crop_size(self, h):
        if self.crop_type == "relative":
            return h * self.crop_size[0]
        if self.crop_type == "relative_range":
            c = float(self.crop_size[0])
            return h * (c + np.random.rand() * (1 - c))
        if self.crop_type == "absolute":
            return min(self.crop_size[0], h)
        # absolute_range
        assert self.crop_size[0] <= self.crop_size[1]
        return np.random.uniform(min(h, self.crop_size[0]), min(h, self.crop_size[1]))

    def __call__(self, points, info):
        if self._rand_range() > self.p:
            return points, info
        pc = np.asarray(self.pc_range, np.float64)
        h = float(pc[3] - pc[0])
        w = float(pc[4] - pc[1])
        assert h == w, "Only square BEV ranges supported (reference constraint)."
        ch = float(self._crop_size(h))
        # crop center in [0, h) coordinates (reference: randint + ch/2)
        x0 = np.random.randint(int(h - ch) + 1) + ch / 2
        y0 = np.random.randint(int(w - ch) + 1) + ch / 2
        center_offset = np.array([x0 - h / 2, y0 - w / 2], np.float64)

        if "annotations" in info:
            boxes = info["annotations"]["gt_boxes"]
            boxes[:, :2] -= center_offset
            keep = G.mask_boxes_outside_range_bev_z_bound(
                boxes, np.array([-ch / 2, -ch / 2, -1e3, ch / 2, ch / 2, 1e3])
            )
            _dict_select(info["annotations"], keep)

        # crop points: shift into [0, h) frame, window, shift back + recenter
        q = points[:, :2] - pc[:2]
        m = (
            (q[:, 0] > x0 - ch / 2) & (q[:, 0] < x0 + ch / 2)
            & (q[:, 1] > y0 - ch / 2) & (q[:, 1] < y0 + ch / 2)
        )
        points = points[m]
        points[:, :2] -= center_offset

        scale = h / ch
        points[:, 0] *= scale
        points[:, 1] *= scale
        if "annotations" in info:
            boxes = info["annotations"]["gt_boxes"]
            boxes[:, [0, 3]] *= scale
            boxes[:, [1, 4]] *= scale
            if boxes.shape[1] == 9:  # velocities
                boxes[:, 6] *= scale
                boxes[:, 7] *= scale
        return points, info


@PROCESSORS.register()
class Voxelization(AugmentationBase):
    """Host hard voxelization (reference `extend_3d.py:255-283`): its output
    is not a `PadPoints` dict, so the loader does not batch it; the model
    voxelizes on the device."""

    def __init__(self, pc_range, voxel_size, max_points_in_voxel, max_voxel_num):
        self._init(locals())
        self.voxel_generator = VoxelGenerator(
            voxel_size=voxel_size, point_cloud_range=pc_range,
            max_num_points=max_points_in_voxel, max_voxels=max_voxel_num,
        )

    def __call__(self, points, info):
        voxels, coords, nper = self.voxel_generator.generate(points)
        out = dict(
            voxels=voxels, points=points, coordinates=coords,
            num_points_per_voxel=nper,
            num_voxels=np.array([voxels.shape[0]], dtype=np.int64),
            shape=self.voxel_generator.grid_size,
            range=self.voxel_generator.point_cloud_range,
            size=self.voxel_generator.voxel_size,
        )
        return out, info


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
