"""TrajectoryFormer-driven tracker (port of `efg_tpu/tracking/tf_tracker.py`).

Per frame the candidates are the current detections and the
motion-predicted boxes of the live tracks, padded to `max_candidates`;
each is scored and refined by the TrajectoryFormer core from its points
and its track's box history, in one call on the module's device; the
refined, rescored candidates are deduplicated and associated greedily on
the host (`tracking/tracker.py`). efg_tpu jits the scoring call; here it
runs eagerly, on the device the caller put the module on.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from efg_tpu_torch.models import trajectoryformer as TF
from efg_tpu_torch.tracking.tracker import GreedyTracker


class TrajectoryFormerTracker:
    def __init__(
        self,
        module: TF.TrajectoryFormer,
        *,
        class_names,
        max_candidates: int = 128,
        history: int = 10,
        num_points: int = 128,
        score_fuse: float = 0.5,
        max_dist: Optional[dict] = None,
    ):
        self.module = module
        self.n_max = max_candidates
        self.history = history
        self.num_points = num_points
        self.score_fuse = score_fuse
        self.base = GreedyTracker(max_dist=max_dist, class_names=class_names)
        self.class_names = list(class_names)
        self.track_history: Dict[int, List[np.ndarray]] = {}

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @torch.inference_mode()
    def score(self, points, points_mask, hyp_boxes, hyp_traj, hyp_traj_mask, group_ids, valid):
        """One frame's candidates (device tensors, no batch dimension) →
        their scores (sigmoid) [N] and refined boxes [N, 7]."""
        self.module.eval()
        hp, hm = TF.crop_hypothesis_points(points[None], points_mask[None], hyp_boxes[None],
                                           num_points=self.num_points)
        out = self.module(hp, hm, hyp_traj[None], hyp_traj_mask[None], hyp_boxes[None],
                          group_ids[None], valid[None])
        refined = TF.apply_refinement(hyp_boxes, out["refine"][0])
        return torch.sigmoid(out["scores"][0]), refined

    def reset(self):
        self.base.reset()
        self.track_history = {}

    def step(self, points: np.ndarray, points_mask: np.ndarray, detections: List[dict],
             time_lag: float = 0.1) -> List[dict]:
        """detections: dicts with box (9,), score, detection_name."""
        cands = list(detections)
        # motion-predicted candidates from live tracks
        for trk in self.base.tracks:
            box = np.asarray(trk.get("box", np.zeros(9))).copy()
            if box.shape[0] >= 8:
                box[:2] += box[6:8] * time_lag
            cands.append(
                dict(
                    box=box,
                    score=float(trk.get("score", 0.1)) * 0.9,
                    detection_name=trk["detection_name"],
                    translation=box[:3].tolist(),
                    velocity=box[6:8].tolist() if box.shape[0] >= 8 else [0, 0],
                    from_track=trk["tracking_id"],
                )
            )
        cands = cands[: self.n_max]
        n = len(cands)
        if n == 0:
            return self.base.step([], time_lag)

        boxes9 = np.zeros((self.n_max, 9), np.float32)
        traj = np.zeros((self.n_max, self.history, 8), np.float32)
        traj_mask = np.zeros((self.n_max, self.history), bool)
        groups = np.arange(self.n_max, dtype=np.int64)
        valid = np.zeros(self.n_max, bool)
        for i, c in enumerate(cands):
            b = np.asarray(c["box"], np.float32)
            boxes9[i, : len(b)] = b
            valid[i] = True
            tid = c.get("from_track")
            hist = self.track_history.get(tid, []) if tid is not None else []
            for t, hb in enumerate(hist[-self.history :]):
                rel = hb.copy()
                rel[:3] -= b[:3]
                traj[i, t, :3] = rel[:3]
                traj[i, t, 3:6] = hb[3:6]
                traj[i, t, 6] = np.sin(hb[-1])
                traj[i, t, 7] = np.cos(hb[-1])
                traj_mask[i, t] = True

        boxes7 = np.concatenate([boxes9[:, :6], boxes9[:, -1:]], axis=1)
        dev = self.device
        scores, refined = self.score(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (points, points_mask, boxes7, traj, traj_mask, groups, valid)))
        scores = scores.cpu().numpy()
        refined = refined.cpu().numpy()

        fused = []
        for i, c in enumerate(cands):
            s = self.score_fuse * float(scores[i]) + (1 - self.score_fuse) * float(c["score"])
            box = np.concatenate([refined[i, :6], boxes9[i, 6:8], refined[i, 6:7]])
            fused.append(
                dict(
                    translation=box[:3].tolist(),
                    velocity=box[6:8].tolist(),
                    detection_name=c["detection_name"],
                    score=s,
                    box=box,
                )
            )

        # candidate dedup (reference `get_keep_mask` + class-agnostic NMS):
        # a track's motion prediction and its matched detection overlap —
        # keep the higher-scored one per neighborhood
        fused.sort(key=lambda d: -d["score"])
        kept: List[dict] = []
        for c in fused:
            ct = np.asarray(c["translation"][:2])
            radius = self.base.max_dist.get(c["detection_name"], 1.0)
            dup = any(
                k["detection_name"] == c["detection_name"]
                and np.linalg.norm(np.asarray(k["translation"][:2]) - ct) < radius * 0.75
                for k in kept
            )
            if not dup:
                kept.append(c)

        tracks = self.base.step(kept, time_lag)
        # update history for live tracks
        for t in tracks:
            self.track_history.setdefault(t["tracking_id"], []).append(
                np.concatenate([np.asarray(t["box"][:6]), np.asarray(t["box"][-1:])])
            )
            self.track_history[t["tracking_id"]] = self.track_history[t["tracking_id"]][
                -self.history :
            ]
        return tracks
