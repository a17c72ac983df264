"""Synthetic multi-frame tracking dataset (a copy of
`efg_tpu/data/datasets/synthetic_tracking.py`).

Sequences of scenes with persistent object identities moving at constant
velocity; each frame carries points, GT boxes with `track_ids`, and noisy
"detections" standing in for a detector's output (the reference
TrajectoryFormer consumes CenterPoint detection pkls —
`playground/tracking.3d/.../env.py`). Enables training the hypothesis
scorer and sequence-ordered tracking eval without Waymo on disk. Each detection
carries its class (`det_labels`): detection i is GT i's noisy copy, so it
is GT i's label, the class efg_tpu's `det_predict` reads from the GT slot
of the same index (the one addition to efg_tpu's items).
"""

from __future__ import annotations

import numpy as np

from efg_tpu_torch.data.base_dataset import BaseDataset
from efg_tpu_torch.data.builder import build_processors
from efg_tpu_torch.data.registry import DATASETS


@DATASETS.register()
class SyntheticTrackingDataset(BaseDataset):
    def __init__(self, config):
        super().__init__(config)
        d = config.dataset
        self.num_sequences = int(d.get("num_sequences", 4))
        self.frames_per_seq = int(d.get("frames_per_seq", 10))
        self.seed = int(d.get("seed", 0))
        self.classes = list(d.get("classes", ["VEHICLE", "PEDESTRIAN", "CYCLIST"]))
        self.pc_range = np.asarray(list(d.pc_range), np.float32)
        self.num_points = int(d.get("points_per_frame", 4096))
        self.max_objects = int(d.get("max_objects", 6))
        self.det_noise = float(d.get("det_noise", 0.2))
        self.with_trajectory = bool(d.get("with_trajectory", False))
        self.traj_length = int(d.get("traj_length", 10))
        self.future_frames = int(d.get("future_frames", 10))
        task = config.get("task", "train")
        self.transforms = build_processors(d.processors[task if task in d.processors else "val"])
        self.sequence_ids = [
            s for s in range(self.num_sequences) for _ in range(self.frames_per_seq)
        ]

    def __len__(self):
        return self.num_sequences * self.frames_per_seq

    def _seq_objects(self, seq: int):
        rs = np.random.RandomState(self.seed * 7919 + seq)
        k = rs.randint(2, self.max_objects + 1)
        starts = rs.uniform(self.pc_range[:2] * 0.6, self.pc_range[3:5] * 0.6, (k, 2))
        vels = rs.uniform(-4, 4, (k, 2))
        dims = np.abs(rs.randn(k, 3) * 0.4 + [4.0, 2.0, 1.6]) + 0.5
        yaws = rs.uniform(-np.pi, np.pi, k)
        classes = rs.randint(1, len(self.classes) + 1, k)
        return starts, vels, dims, yaws, classes

    def __getitem__(self, idx):
        seq, f = divmod(idx, self.frames_per_seq)
        starts, vels, dims, yaws, classes = self._seq_objects(seq)
        rs = np.random.RandomState(self.seed * 104729 + idx)
        t = f * 0.1
        centers = np.concatenate(
            [starts + vels * t, np.zeros((len(starts), 1))], axis=1
        )
        gt_boxes = np.concatenate(
            [centers, dims, vels, yaws[:, None]], axis=1
        ).astype(np.float32)  # [K, 9]

        clusters = []
        for c, dm, yw in zip(centers, dims, yaws):
            npts = rs.randint(30, 120)
            local = rs.uniform(-0.5, 0.5, (npts, 3)) * dm
            cs, sn = np.cos(yw), np.sin(yw)
            world = np.stack(
                [local[:, 0] * cs - local[:, 1] * sn,
                 local[:, 0] * sn + local[:, 1] * cs, local[:, 2]], axis=1
            ) + c
            clusters.append(world)
        bg = rs.uniform(self.pc_range[:3], self.pc_range[3:], (1000, 3))
        xyz = np.concatenate([bg] + clusters).astype(np.float32)
        points = np.concatenate([xyz, rs.uniform(0, 1, (len(xyz), 2)).astype(np.float32)], 1)

        det_boxes = gt_boxes.copy()
        det_boxes[:, :2] += rs.randn(len(det_boxes), 2) * self.det_noise
        det_boxes[:, 8] += rs.randn(len(det_boxes)) * 0.05
        det_scores = np.clip(rs.uniform(0.5, 1.0, len(det_boxes)), 0, 1).astype(np.float32)

        info = {
            "metadata": {
                "token": f"track-{seq}-{f}",
                "sequence": seq,
                "frame": f,
                "num_point_features": points.shape[1],
                "db_path": "",
            },
            "annotations": {
                "gt_boxes": gt_boxes,
                "gt_names": np.asarray([self.classes[c - 1] for c in classes]),
                "labels": classes.astype(np.int64),
                "track_ids": np.arange(len(gt_boxes), dtype=np.int64) + seq * 1000,
                "det_boxes": det_boxes,
                "det_scores": det_scores,
                "det_labels": classes.astype(np.int64),
                "difficulty": np.zeros(len(gt_boxes), np.int8),
                "num_points_in_gt": np.full(len(gt_boxes), 60, np.int64),
            },
            "sweeps": [],
        }
        if self.with_trajectory:
            # constant-velocity history (current-relative boxes, reference
            # motionpred input) and future center offsets
            k = len(gt_boxes)
            th, tf = self.traj_length, self.future_frames
            steps = np.arange(1, th + 1, dtype=np.float32)  # frames back
            hist = np.zeros((k, th, 8), np.float32)
            hist[..., 0:2] = -vels[:, None, :] * 0.1 * steps[None, :, None]
            hist[..., 3:6] = dims[:, None, :]
            hist[..., 6] = 0.0  # sin of relative yaw (constant heading)
            hist[..., 7] = 1.0  # cos
            hist_mask = steps[None, :] <= f  # frames before seq start invalid
            hist_mask = np.broadcast_to(hist_mask, (k, th)).copy()
            fsteps = np.arange(1, tf + 1, dtype=np.float32)
            fut = np.zeros((k, tf, 3), np.float32)
            fut[..., 0:2] = vels[:, None, :] * 0.1 * fsteps[None, :, None]
            fut_mask = (f + fsteps[None, :]) < self.frames_per_seq
            fut_mask = np.broadcast_to(fut_mask, (k, tf)).copy()
            info["annotations"]["traj_hist"] = hist
            info["annotations"]["traj_mask"] = hist_mask
            info["annotations"]["future_offsets"] = fut
            info["annotations"]["future_mask"] = fut_mask
        points, info = self._apply_transforms(points, info)
        return points, info
