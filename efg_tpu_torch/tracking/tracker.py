"""Greedy 3D multi-object tracker (host-side numpy): a copy of
`efg_tpu/tracking/tracker.py`.

CenterPoint-style `PubTracker`: predicted
centers via negative velocity × time-lag, class-gated greedy
nearest-center association, birth on unmatched detections, death after
`max_age` missed frames. Consumes per-frame detections (optionally
refined/re-scored by TrajectoryFormer).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

WAYMO_TRACKING_NAMES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
DEFAULT_MAX_DIST = {"VEHICLE": 1.2, "PEDESTRIAN": 0.5, "CYCLIST": 0.8}


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """Row-wise greedy argmin assignment (reference `greedy_assignment`)."""
    matched = []
    if dist.shape[1] == 0:
        return np.zeros((0, 2), np.int32)
    for i in range(dist.shape[0]):
        j = dist[i].argmin()
        if dist[i][j] < 1e16:
            dist[:, j] = 1e18
            matched.append([i, j])
    return np.asarray(matched, np.int32).reshape(-1, 2)


class GreedyTracker:
    def __init__(
        self,
        max_dist: Optional[Dict[str, float]] = None,
        max_age: int = 3,
        min_hits: int = 1,
        class_names=WAYMO_TRACKING_NAMES,
    ):
        self.max_dist = dict(DEFAULT_MAX_DIST, **(max_dist or {}))
        self.max_age = max_age
        self.min_hits = min_hits
        self.class_names = list(class_names)
        self.reset()

    def reset(self):
        self.id_count = 0
        self.tracks: List[dict] = []

    def step(self, detections: List[dict], time_lag: float) -> List[dict]:
        """detections: dicts with `translation` [3], `velocity` [2],
        `detection_name`, `score`, `box` [7+]. Returns the updated active
        track list (each with `tracking_id`, `age`, `active`)."""
        dets = []
        for det in detections:
            if det["detection_name"] not in self.class_names:
                continue
            det = dict(det)
            det["ct"] = np.asarray(det["translation"][:2], np.float64)
            det["tracking"] = -np.asarray(det.get("velocity", (0, 0))[:2]) * time_lag
            det["label"] = self.class_names.index(det["detection_name"])
            dets.append(det)

        n, m = len(dets), len(self.tracks)
        if n and m:
            pred_ct = np.stack([d["ct"] + d["tracking"] for d in dets])  # [N, 2]
            track_ct = np.stack([t["ct"] for t in self.tracks])  # [M, 2]
            dist = np.sqrt(((pred_ct[:, None] - track_ct[None]) ** 2).sum(-1))
            max_diff = np.asarray([self.max_dist[d["detection_name"]] for d in dets])
            det_cat = np.asarray([d["label"] for d in dets])
            trk_cat = np.asarray([t["label"] for t in self.tracks])
            invalid = (dist > max_diff[:, None]) | (det_cat[:, None] != trk_cat[None])
            dist = dist + invalid * 1e18
            matches = greedy_assignment(copy.deepcopy(dist))
        else:
            matches = np.zeros((0, 2), np.int32)

        matched_dets = set(matches[:, 0].tolist())
        matched_trks = set(matches[:, 1].tolist())

        out: List[dict] = []
        for di, ti in matches:
            trk = self.tracks[ti]
            d = dets[di]
            d["tracking_id"] = trk["tracking_id"]
            d["age"] = 1
            d["active"] = trk["active"] + 1
            out.append(d)

        for di, d in enumerate(dets):
            if di in matched_dets:
                continue
            self.id_count += 1
            d["tracking_id"] = self.id_count
            d["age"] = 1
            d["active"] = 1
            out.append(d)

        # keep unmatched tracks alive up to max_age, coasting by velocity
        for ti, trk in enumerate(self.tracks):
            if ti in matched_trks:
                continue
            if trk["age"] < self.max_age:
                trk = dict(trk)
                trk["age"] += 1
                trk["active"] = 0
                trk["ct"] = trk["ct"] - trk.get("tracking", np.zeros(2))
                out.append(trk)

        self.tracks = out
        return [t for t in out if t["active"] >= self.min_hits]
