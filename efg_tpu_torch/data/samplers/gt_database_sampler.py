"""GT-database copy-paste sampler (a copy of
`efg_tpu/data/samplers/gt_database_sampler.py`): per-class quota top-up
from a pickled crop database, with the numpy BEV collision rejection
(efg_tpu's native C++ test is not ported).

The sampler keeps state across items, as efg_tpu's does: each class's
`BatchSampler` shuffles its crops once when it is built (numpy's global
RNG at processor-build time), advances a cyclic position with every item,
and reshuffles from the RNG stream of the item that wraps it. So the crops
an item gets depend on every item this process sampled before it. The
stream is efg_tpu's only in one process that loads every item of the
machine's batches in order (`num_workers: 0`, one local rank). It is
sharded by machine (efg_tpu's process); under data parallelism each local
rank loads only its slice of a batch (`data/builder.py`), so its sampler
advances over its own rows only (a stated deviation, ROADMAP queue 3).
"""

from __future__ import annotations

import copy
import logging
import math
import os
import pickle
from typing import Dict, List

import numpy as np

from efg_tpu_torch.geometry import box_ops_np as G
from efg_tpu_torch.utils import distributed as comm
from efg_tpu_torch.utils.file_io import PathManager
from efg_tpu_torch.utils.logger import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def _num_shards():
    """(machines, this machine's rank): efg_tpu shards by its processes,
    one a machine."""
    return comm.get_num_machines(), comm.get_machine_rank()


class BatchSampler:
    """Shuffled cyclic sampler over one class's crop list, sharded across
    machines."""

    def __init__(self, sampled_list: List, name=None, shuffle: bool = True):
        num_replicas, rank = _num_shards()
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = int(math.ceil(len(sampled_list) / num_replicas))
        self.total_size = self.num_samples * num_replicas

        self._sampled_list = sampled_list
        self._shuffle = shuffle
        self._name = name
        self._indices = self._get_indices()
        self._idx = 0

    def _get_indices(self):
        indices = list(range(len(self._sampled_list)))
        if self._shuffle:
            np.random.shuffle(indices)
        indices += indices[: self.total_size - len(self._sampled_list)]
        offset = self.num_samples * self.rank
        return indices[offset : offset + self.num_samples]

    def _reset(self):
        if self._shuffle:
            np.random.shuffle(self._indices)
        self._idx = 0

    def sample(self, num: int) -> List:
        if self._idx + num >= self.num_samples:
            ret = list(self._indices[self._idx :])
            self._reset()
        else:
            ret = self._indices[self._idx : self._idx + num]
            self._idx += num
        return [self._sampled_list[i] for i in ret]


class DataBaseSampler:
    """Per-class quota top-up from the crop database at `db_info_path`."""

    def __init__(self, db_info_path, groups, min_points=0, difficulty=-1):
        self.db_info_path = db_info_path
        self.min_points = min_points
        self.difficulty = difficulty
        self._groups = groups
        self._sample_classes: List[str] = []
        self._sample_max_nums: List[int] = []
        self._init_db()

    def _init_db(self):
        db_infos: Dict[str, List] = pickle.load(PathManager.open(self.db_info_path, "rb"))
        filtered = {}
        for name, infos in db_infos.items():
            filtered[name] = [
                i
                for i in infos
                if i["num_points_in_gt"] >= self.min_points and i["difficulty"] >= self.difficulty
            ]
            logger.info(f"GT-DB {name}: {len(infos)} → {len(filtered[name])} after filtering")
        self._group_db_infos = filtered
        for group in self._groups:
            self._sample_classes += list(group.keys())
            self._sample_max_nums += list(group.values())
        self._sampler_dict = {k: BatchSampler(v, k) for k, v in filtered.items()}

    def sample_all(self, root_path, gt_boxes, gt_names, points_dim):
        sampled, sampled_gt_boxes = [], []
        avoid = gt_boxes
        for cls, max_num in zip(self._sample_classes, self._sample_max_nums):
            want = int(max_num - np.sum(gt_names == cls))
            if want <= 0:
                continue
            picked = self._sample_class(cls, want, avoid)
            sampled += picked
            if picked:
                boxes = np.stack([p["box3d_lidar"] for p in picked], axis=0)
                sampled_gt_boxes.append(boxes)
                avoid = np.concatenate([avoid, boxes], axis=0)
        if not sampled:
            return None

        boxes_all = np.concatenate(sampled_gt_boxes, axis=0)
        pts_list = []
        for info in sampled:
            path = os.path.join(root_path, info["path"])
            pts = (
                np.frombuffer(PathManager.open(path, "rb").read(), np.float32)
                .copy()
                .reshape(-1, points_dim)
            )
            pts[:, :3] += info["box3d_lidar"][:3]
            pts_list.append(pts)
        return {
            "gt_boxes": boxes_all,
            "gt_names": np.array([s["name"] for s in sampled]),
            "difficulty": np.array([s["difficulty"] for s in sampled]),
            "num_points_in_gt": np.array([s["num_points_in_gt"] for s in sampled]),
            "points": np.concatenate(pts_list, axis=0),
        }

    def _sample_class(self, name, num, gt_boxes):
        if name not in self._sampler_dict:
            return []
        picked = copy.deepcopy(self._sampler_dict[name].sample(num))
        if not picked:
            return []
        num_gt = gt_boxes.shape[0]
        sp_boxes = np.stack([p["box3d_lidar"] for p in picked], axis=0)
        all_boxes = np.concatenate([gt_boxes, sp_boxes], axis=0)
        corners = G.boxes_to_corners_bev(all_boxes)
        coll = G.box_collision_test(corners, corners)
        np.fill_diagonal(coll, False)

        valid = []
        for i in range(num_gt, num_gt + len(picked)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(picked[i - num_gt])
        return valid
