"""nuScenes detection dataset with CBGS class-balanced resampling (a copy
of `efg_tpu/data/datasets/nuscenes.py`): the info-pkl format that
`efg_tpu_torch.cli.data_preparation.nuscenes.create_data` writes,
multi-sweep loading with the sweeps' transforms, the nuScenes→EFG
coordinate swap (x, y → y, −x), CBGS resampling at info-load time.

Three stated deviations, without which neither experiment trains on or
evaluates against a GT box that lies where its points are:
- `create_data` writes nuScenes' general category names ("vehicle.car"),
  and efg_tpu's dataset never maps them to the detection classes ("car"),
  so every box fails its class filter and CBGS finds no class. Here the
  names go through `GENERAL_TO_DETECTION` when the infos are loaded,
  before CBGS (detection names pass as they are), and the boxes it maps
  to "ignore" are dropped by the existing filter.
- `create_data` writes the boxes in nuScenes' lidar frame, and efg_tpu's
  dataset turns the points into the EFG frame but not the boxes, which
  then lie a quarter-turn about the sensor away from their points. Here
  the boxes take the same turn when the infos are loaded (`to_efg_frame`).
- efg_tpu filters an item's annotations to the configured classes and
  gives them `labels` only when training, so a val item keeps GT boxes
  without labels, which `collate_fixed` cannot batch (a KeyError in
  efg_tpu's `pad_gt`) and `nuScenesDetEvaluator` could not match. Here
  every item that has annotations is filtered and labelled as a training
  item is, as `WaymoDetectionDataset` does in both packages.
"""

from __future__ import annotations

import os
import pickle
from copy import deepcopy

import numpy as np

from efg_tpu_torch.data.base_dataset import BaseDataset
from efg_tpu_torch.data.builder import build_processors
from efg_tpu_torch.data.registry import DATASETS
from efg_tpu_torch.utils.file_io import PathManager

# reference `efg/data/datasets/nuscenes/__init__.py` general_to_detection map
GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


# Per-class attribute frequency priors over the nuScenes trainset
# (reference `efg/data/datasets/nuscenes/utils.py:32-155` `cls_attr_dist`;
# zero-count attributes omitted). Used by the evaluator's attribute
# assignment fallback: when the velocity rule doesn't decide, the most
# frequent attribute for the class is predicted.
CLS_ATTR_DIST = {
    "barrier": {},
    "traffic_cone": {},
    "bicycle": {"cycle.with_rider": 2791, "cycle.without_rider": 8946},
    "motorcycle": {"cycle.with_rider": 4233, "cycle.without_rider": 8326},
    "pedestrian": {
        "pedestrian.moving": 157444,
        "pedestrian.sitting_lying_down": 13939,
        "pedestrian.standing": 46530,
    },
    "car": {
        "vehicle.moving": 114304,
        "vehicle.parked": 330133,
        "vehicle.stopped": 46898,
    },
    "bus": {
        "vehicle.moving": 9092,
        "vehicle.parked": 3294,
        "vehicle.stopped": 3881,
    },
    "construction_vehicle": {
        "vehicle.moving": 882,
        "vehicle.parked": 11549,
        "vehicle.stopped": 2102,
    },
    "trailer": {
        "vehicle.moving": 3421,
        "vehicle.parked": 19224,
        "vehicle.stopped": 1895,
    },
    "truck": {
        "vehicle.moving": 21339,
        "vehicle.parked": 55626,
        "vehicle.stopped": 11097,
    },
}


def read_file(path: str, num_point_feature: int = 4):
    data = PathManager.open(path, "rb").read()
    points = np.copy(np.frombuffer(data, np.float32))
    s = points.shape[0]
    if s % 5 != 0:
        points = points[: s - (s % 5)]
    return points.reshape(-1, 5)[:, :num_point_feature]


def remove_close(points: np.ndarray, radius: float) -> np.ndarray:
    return ~((np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius))


def read_sweep(sweep: dict):
    pts = read_file(sweep["data_path"])
    pts = pts[remove_close(pts, 1.0)].T
    n = pts.shape[1]
    if sweep.get("transform_matrix") is not None:
        pts[:3, :] = sweep["transform_matrix"].dot(np.vstack((pts[:3, :], np.ones(n))))[:3, :]
    times = sweep["time_lag"] * np.ones((1, n))
    return pts.T, times.T


def to_efg_frame(annotations: dict) -> dict:
    """An info's annotations from create_data's form into the form the
    dataset trains on, in place: category names mapped to the detection
    classes, and the boxes (x, y, z, l, w, h[, vx, vy], yaw) turned as the
    points are, x, y → y, −x: the centre and the velocity turn, the yaw
    drops by π/2 (wrapped into [−π, π)), the sizes stay."""
    names = annotations["gt_names"]
    if len(names):
        annotations["gt_names"] = np.asarray([GENERAL_TO_DETECTION.get(n, n) for n in names])
    boxes = annotations["gt_boxes"].copy()
    boxes[:, 0], boxes[:, 1] = annotations["gt_boxes"][:, 1], -annotations["gt_boxes"][:, 0]
    if boxes.shape[1] == 9:
        boxes[:, 6], boxes[:, 7] = annotations["gt_boxes"][:, 7], -annotations["gt_boxes"][:, 6]
    boxes[:, -1] = np.mod(boxes[:, -1] - np.pi / 2 + np.pi, 2 * np.pi) - np.pi
    annotations["gt_boxes"] = boxes
    return annotations


@DATASETS.register()
class nuScenesDetectionDataset(BaseDataset):
    REF_CHANNEL = "LIDAR_TOP"

    def __init__(self, config):
        super().__init__(config)
        d = config.dataset
        self.is_train = config.task == "train"
        self.nsweeps = int(d.get("nsweeps", 1))
        self.load_interval = int(d.get("load_interval", 1))
        self.class_names = list(d.classes)

        source = d.source if self.is_train else d.get("eval_source", d.source)
        self.root_path = source.root
        self.info_path = self.root_path + source[config.task]
        self.db_path = self.info_path.split("/infos")[0]

        self.dataset_dicts = self._load_infos(d)
        task = config.task if config.task in d.processors else "val"
        self.transforms = build_processors(d.processors[task])

    def _load_infos(self, d):
        infos_all = pickle.load(PathManager.open(self.info_path, "rb"))
        if isinstance(infos_all, dict):
            flat = []
            for v in infos_all.values():
                flat.extend(v)
            infos_all = flat
        infos_all = infos_all[:: self.load_interval]
        for info in infos_all:
            if "annotations" in info:
                to_efg_frame(info["annotations"])
        if not (self.is_train and d.get("cbgs", True)):
            return infos_all

        # CBGS resampling (reference `load_infos`, `nuscenes.py:90-124`)
        cls_infos = {name: [] for name in self.class_names}
        for info in infos_all:
            for name in set(info["annotations"]["gt_names"]):
                if name in cls_infos:
                    cls_infos[name].append(info)
        dup = sum(len(v) for v in cls_infos.values())
        if dup == 0:
            return infos_all
        dist = {k: len(v) / dup for k, v in cls_infos.items()}
        frac = 1.0 / len(self.class_names)
        out = []
        for name, infos in cls_infos.items():
            if not infos:
                continue
            ratio = frac / dist[name]
            out += np.random.choice(infos, int(len(infos) * ratio)).tolist()
        return out

    def __len__(self):
        return len(self.dataset_dicts)

    def __getitem__(self, idx):
        all_info = deepcopy(self.dataset_dicts[idx])
        info = {k: all_info[k] for k in ("sample_token", "annotations") if k in all_info}
        info.update(all_info[self.REF_CHANNEL] if self.REF_CHANNEL in all_info else all_info)

        lidar_path = info["data_path"]
        if not os.path.isabs(lidar_path):
            lidar_path = os.path.join(os.environ.get("EFG_PATH", "."), lidar_path)
        points = read_file(lidar_path)

        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1))]
        for sweep in info.get("sweeps", [])[: self.nsweeps - 1]:
            if not os.path.isabs(sweep["data_path"]):
                sweep["data_path"] = os.path.join(os.environ.get("EFG_PATH", "."), sweep["data_path"])
            p, t = read_sweep(sweep)
            sweep_points.append(p)
            sweep_times.append(t)
        points = np.concatenate(sweep_points)
        times = np.concatenate(sweep_times).astype(points.dtype)
        points = np.hstack([points, times])

        # nuScenes → EFG coordinates: x, y → y, −x (reference `:176-179`)
        points[:, :2] = points[:, [1, 0]]
        points[:, 1] *= -1

        info["metadata"] = {
            "root_path": self.root_path,
            "db_path": self.db_path,
            "token": info.get("sample_token", str(idx)),
            "num_point_features": points.shape[-1],
        }

        if "annotations" in info:
            names = info["annotations"]["gt_names"]
            keep = ~np.isin(names, ["ignore", "DontCare"])
            for k, v in list(info["annotations"].items()):
                if isinstance(v, np.ndarray) and len(v) == len(keep):
                    info["annotations"][k] = v[keep]

        points, info = self._apply_transforms(points, info)

        if "annotations" in info:
            tgt = info["annotations"]
            keep = (tgt["gt_names"][:, None] == np.asarray(self.class_names)).any(axis=1)
            for k, v in list(tgt.items()):
                if isinstance(v, np.ndarray) and len(v) == len(keep):
                    tgt[k] = v[keep]
            tgt["labels"] = np.array(
                [self.class_names.index(n) + 1 for n in tgt["gt_names"]], np.int64
            ).reshape(-1)
        return points, info
