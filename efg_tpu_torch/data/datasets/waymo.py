"""Waymo detection dataset (a copy of `efg_tpu/data/datasets/waymo.py`):
pickled `infos` + per-frame lidar pickles, in the format that
`efg_tpu_torch.cli.data_preparation.waymo` writes (info pkl list;
per-frame pickled dicts with `lidars/points_xyz` + `points_feature`;
multi-sweep concatenation with a trailing per-point time-lag channel and
pose-chained transforms).
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

CAT_TO_IDX = {"UNKNOWN": 0, "VEHICLE": 1, "PEDESTRIAN": 2, "SIGN": 3, "CYCLIST": 4}
IDX_TO_CAT = ["UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST"]
LABEL_TO_TYPE = {1: 1, 2: 2, 3: 4}  # framework label → waymo type (sign skipped)


def read_single_waymo(obj: dict) -> np.ndarray:
    """Frame pickle → [N, 5] (x, y, z, intensity, elongation)
    (reference `datasets/waymo/utils.py:9-25`)."""
    points_xyz = obj["lidars"]["points_xyz"]
    points_feature = obj["lidars"]["points_feature"]
    points_feature[:, 0] = np.tanh(points_feature[:, 0])
    return np.concatenate([points_xyz, points_feature], axis=-1).astype(np.float32)


def read_single_waymo_sweep(sweep: dict, obj: dict):
    """Sweep pickle → points transformed into the reference frame + per-point
    time lag (reference `datasets/waymo/utils.py:28-60`)."""
    points_xyz = obj["lidars"]["points_xyz"]
    points_feature = obj["lidars"]["points_feature"]
    points_feature[:, 0] = np.tanh(points_feature[:, 0])
    points_sweep = np.concatenate([points_xyz, points_feature], axis=-1).T  # [5, N]

    n = points_sweep.shape[1]
    tm = sweep.get("transform_matrix")
    if tm is not None:
        points_sweep[:3, :] = tm.dot(
            np.vstack((points_sweep[:3, :], np.ones(n)))
        )[:3, :]
    times = sweep["time_lag"] * np.ones((1, n))
    return points_sweep.T.astype(np.float32), times.T.astype(np.float32)


@DATASETS.register()
class WaymoDetectionDataset(BaseDataset):
    def __init__(self, config):
        super().__init__(config)
        d = config.dataset
        self.is_test = config.task == "test"
        self.class_names = list(d.classes)
        self.load_interval = int(d.get("load_interval", 1))
        self.nsweeps = int(d.get("nsweeps", 1))
        fmt = d.get("format", "XYZIT")
        self.num_point_features = len(fmt) if self.nsweeps == 1 else len(fmt) + 1

        source = d.source
        self.root_path = source.root
        self.info_path = self.root_path + source[config.task]
        self.db_path = self.info_path.split("/infos")[0]

        self.dataset_dicts = self._load_infos()
        task = config.task if config.task != "test" else "val"
        self.transforms = build_processors(d.processors[config.task if config.task in d.processors else task])

    def _load_infos(self):
        infos = pickle.load(PathManager.open(self.info_path, "rb"))
        return infos[:: self.load_interval]

    def __len__(self):
        return len(self.dataset_dicts)

    def __getitem__(self, idx):
        info = deepcopy(self.dataset_dicts[idx])
        if not os.path.isabs(info["path"]):
            info["path"] = os.path.join(self.root_path, info["path"])
        obj = pickle.load(PathManager.open(info["path"], "rb"))
        points = read_single_waymo(obj)

        if self.nsweeps > 1:
            sweep_points = [points]
            sweep_times = [np.zeros((points.shape[0], 1), np.float32)]
            assert (self.nsweeps - 1) <= len(info["sweeps"])
            for sweep in info["sweeps"][: self.nsweeps - 1]:
                sobj = pickle.load(PathManager.open(sweep["path"], "rb"))
                p, t = read_single_waymo_sweep(sweep, sobj)
                sweep_points.append(p)
                sweep_times.append(t)
            points = np.hstack(
                [np.concatenate(sweep_points), np.concatenate(sweep_times).astype(np.float32)]
            )

        info["metadata"] = {
            "root_path": self.root_path,
            "db_path": self.db_path,
            "token": info["token"],
            "num_point_features": self.num_point_features,
        }

        if not self.is_test:
            if "annotations" not in info:
                info["annotations"] = {
                    "gt_boxes": info.pop("gt_boxes").astype(np.float32),
                    "gt_names": info.pop("gt_names"),
                    "difficulty": info.pop("difficulty").astype(np.int8),
                    "num_points_in_gt": info.pop("num_points_in_gt").astype(np.int64),
                }
        self._before_transforms(idx, info)
        if not self.is_test:
            self._filter_gt_by_classes(info)
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    self._filter_gt_by_classes(sweep)

        points, info = self._apply_transforms(points, info)

        if not self.is_test:
            self._add_labels(info)
            for sweep in info.get("sweeps", []):
                if "annotations" in sweep:
                    self._add_labels(sweep)
        return points, info

    def _before_transforms(self, idx, info) -> None:
        """What a subclass adds to an item before the class filter and the
        processors run (`WaymoTrackingDataset`: the frame's detections and
        its GT's track ids)."""

    def _filter_gt_by_classes(self, info):
        tgt = info["annotations"]
        keep = (tgt["gt_names"][:, None] == np.asarray(self.class_names)).any(axis=1)
        for k, v in list(tgt.items()):
            if isinstance(v, np.ndarray) and len(v) == len(keep):
                tgt[k] = v[keep]

    def _add_labels(self, info):
        info["annotations"]["labels"] = np.array(
            [self.class_names.index(n) + 1 for n in info["annotations"]["gt_names"]],
            np.int64,
        ).reshape(-1)
