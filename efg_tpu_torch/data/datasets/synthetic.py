"""Synthetic 3D detection dataset: procedurally generated LiDAR-like
scenes (a copy of `efg_tpu/data/datasets/synthetic.py`). Scenes are
deterministic per (seed, index): boxes with dense surface point clusters
over sparse ground clutter, with `gt_boxes [G, 9]` and `gt_names`
annotations.
"""

from __future__ import annotations

import numpy as np

from efg_tpu_torch.data.base_dataset import BaseDataset
from efg_tpu_torch.data.builder import build_processors
from efg_tpu_torch.data.registry import DATASETS


@DATASETS.register()
class Synthetic3DDataset(BaseDataset):
    def __init__(self, config):
        super().__init__(config)
        d = config.dataset
        self.size = int(d.get("num_frames", 64))
        self.seed = int(d.get("seed", 0))
        self.classes = list(d.get("classes", ["VEHICLE", "PEDESTRIAN", "CYCLIST"]))
        self.pc_range = np.asarray(list(d.pc_range), np.float32)
        self.num_points = int(d.get("points_per_frame", 8192))
        self.max_objects = int(d.get("max_objects", 12))
        task = config.get("task", "train")
        self.transforms = build_processors(d.processors[task if task != "test" else "val"])
        self.is_test = task == "test"

    def __len__(self) -> int:
        return self.size

    def _gen_scene(self, idx: int):
        rs = np.random.RandomState(self.seed * 100003 + idx)
        lo, hi = self.pc_range[:3], self.pc_range[3:]
        span = hi - lo
        k = rs.randint(1, self.max_objects + 1)

        sizes_by_class = {
            "VEHICLE": ([4.7, 2.1, 1.7], 0.4),
            "PEDESTRIAN": ([0.9, 0.85, 1.7], 0.1),
            "CYCLIST": ([1.8, 0.8, 1.7], 0.2),
        }
        names, boxes, clusters = [], [], []
        for _ in range(k):
            cls = self.classes[rs.randint(len(self.classes))]
            base, jitter = sizes_by_class.get(cls, ([2.0, 2.0, 2.0], 0.3))
            dims = np.abs(np.asarray(base) + rs.randn(3) * jitter) + 0.3
            center = lo + span * rs.uniform(0.1, 0.9, 3)
            center[2] = rs.uniform(lo[2] + dims[2] / 2, min(hi[2], lo[2] + dims[2] / 2 + 1.0))
            yaw = rs.uniform(-np.pi, np.pi)
            vel = rs.randn(2) * 2.0
            boxes.append(np.concatenate([center, dims, vel, [yaw]]))
            names.append(cls)
            # surface-ish points inside the box
            npts = rs.randint(40, 200)
            local = rs.uniform(-0.5, 0.5, (npts, 3)) * dims
            edge = rs.randint(0, 3, npts)
            sign = rs.choice([-0.5, 0.5], npts)
            local[np.arange(npts), edge] = sign * dims[edge] * 0.98
            c, s = np.cos(yaw), np.sin(yaw)
            world = np.stack(
                [local[:, 0] * c - local[:, 1] * s, local[:, 0] * s + local[:, 1] * c, local[:, 2]],
                axis=1,
            ) + center
            clusters.append(world)

        n_bg = max(self.num_points - sum(len(c) for c in clusters), 100)
        bg = lo + span * rs.uniform(0, 1, (n_bg, 3)).astype(np.float32)
        bg[:, 2] = lo[2] + np.abs(rs.randn(n_bg)) * 0.2  # mostly ground
        xyz = np.concatenate([bg] + clusters, axis=0).astype(np.float32)
        intensity = rs.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
        elong = rs.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
        points = np.concatenate([xyz, intensity, elong], axis=1)

        boxes = np.asarray(boxes, np.float32).reshape(-1, 9)
        return points, boxes, np.asarray(names)

    def __getitem__(self, idx: int):
        points, gt_boxes, gt_names = self._gen_scene(idx)
        info = {
            "metadata": {
                "token": f"synthetic-{self.seed}-{idx}",
                "num_point_features": points.shape[1],
                "db_path": "",
            },
            "annotations": {
                "gt_boxes": gt_boxes,
                "gt_names": gt_names,
                "difficulty": np.ones(len(gt_boxes), np.int8),
                "num_points_in_gt": np.full(len(gt_boxes), 50, np.int64),
            },
            "sweeps": [],
        }
        points, info = self._apply_transforms(points, info)
        if "annotations" in info:
            info["annotations"]["labels"] = np.array(
                [self.classes.index(n) + 1 for n in info["annotations"]["gt_names"]],
                np.int64,
            )
        return points, info
