"""3D tracking evaluator: in-process MOTA / ID metrics (a copy of
`efg_tpu/evaluator/tracking_evaluator.py`; the frames of every rank are
gathered through `utils/distributed.py`).

Rebuild of the reference `CustomWaymoTrackEvaluator` (`playground/
tracking.3d/.../track_evaluator.py`), which shelled out to the Waymo TF
tracking metrics; here CLEAR-MOT metrics are computed directly: per-frame
center-distance matching (greedy, class-gated) yields MOTA (1 − (FN + FP +
IDSW)/GT), MOTP (mean matched distance), and ID switches.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator
from efg_tpu_torch.evaluator.registry import EVALUATORS
from efg_tpu_torch.utils import distributed as comm
from efg_tpu_torch.utils.logger import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


class MOTAccumulator:
    def __init__(self, match_dist: float = 2.0):
        self.match_dist = match_dist
        self.fn = self.fp = self.idsw = self.n_gt = 0
        self.dist_sum = 0.0
        self.n_match = 0
        self._last_match: Dict[int, int] = {}  # gt id → track id

    def add_frame(self, trk_ct, trk_ids, gt_ct, gt_ids):
        n, m = len(trk_ct), len(gt_ct)
        self.n_gt += m
        if m == 0:
            self.fp += n
            return
        if n == 0:
            self.fn += m
            self._last_match = {}
            return
        d = np.linalg.norm(gt_ct[:, None] - trk_ct[None], axis=-1)  # [M, N]
        taken = np.zeros(n, bool)
        matched_gt = np.zeros(m, bool)
        # prefer persisting existing gt→track pairs (CLEAR-MOT)
        for gi in range(m):
            tid = self._last_match.get(int(gt_ids[gi]))
            if tid is None:
                continue
            js = np.where(~taken & (trk_ids == tid))[0]
            if js.size and d[gi, js[0]] <= self.match_dist:
                j = js[0]
                taken[j] = True
                matched_gt[gi] = True
                self.dist_sum += d[gi, j]
                self.n_match += 1
        new_match = {}
        for gi in np.argsort([d[i].min() for i in range(m)]):
            if matched_gt[gi]:
                new_match[int(gt_ids[gi])] = self._last_match[int(gt_ids[gi])]
                continue
            cand = np.where(~taken)[0]
            if cand.size == 0:
                continue
            j = cand[np.argmin(d[gi, cand])]
            if d[gi, j] <= self.match_dist:
                taken[j] = True
                matched_gt[gi] = True
                self.dist_sum += d[gi, j]
                self.n_match += 1
                tid = int(trk_ids[j])
                if int(gt_ids[gi]) in self._last_match and self._last_match[int(gt_ids[gi])] != tid:
                    self.idsw += 1
                new_match[int(gt_ids[gi])] = tid
        self.fn += int((~matched_gt).sum())
        self.fp += int((~taken).sum())
        self._last_match = new_match

    def summarize(self) -> Dict[str, float]:
        mota = 1.0 - (self.fn + self.fp + self.idsw) / max(self.n_gt, 1)
        motp = self.dist_sum / max(self.n_match, 1)
        return dict(MOTA=mota, MOTP=motp, FP=self.fp, FN=self.fn, IDSW=self.idsw,
                    n_gt=self.n_gt)


@EVALUATORS.register()
class TrackingEvaluator(DatasetEvaluator):
    def __init__(self, config, dataset):
        self.class_names = list(config.dataset.classes)
        self._frames: List[dict] = []

    def reset(self):
        self._frames = []
        self._tracker = None

    def process(self, inputs, outputs):
        """outputs per sample: either `tracks` (list of dicts with
        `translation`, `tracking_id`, `label`) or raw fixed-shape detections
        (box3d/scores/labels/valid) — in the latter case an internal
        GreedyTracker runs over the sequence-ordered stream (the engine's
        eval loop is stateless; tracking state lives here)."""
        if "tracks" not in outputs:
            from efg_tpu_torch.tracking.tracker import GreedyTracker

            if not hasattr(self, "_tracker") or self._tracker is None:
                self._tracker = GreedyTracker(class_names=self.class_names)
            bsz = len(inputs["annotations"])
            track_lists = []
            for b in range(bsz):
                valid = np.asarray(outputs["valid"][b])
                boxes = np.asarray(outputs["box3d"][b])[valid]
                scores = np.asarray(outputs["scores"][b])[valid]
                labels = np.asarray(outputs["labels"][b])[valid]
                dets = []
                for box, sc, lb in zip(boxes, scores, labels):
                    if lb < 1:
                        continue
                    vel = box[6:8] if box.shape[0] > 7 else np.zeros(2)
                    dets.append(
                        dict(
                            translation=box[:3].tolist(),
                            velocity=vel.tolist(),
                            detection_name=self.class_names[int(lb) - 1],
                            score=float(sc),
                            box=box,
                        )
                    )
                tracks = self._tracker.step(dets, time_lag=0.1)
                track_lists.append(
                    [
                        dict(translation=t["translation"], tracking_id=t["tracking_id"],
                             label=t["label"], box=t.get("box"),
                             score=t.get("score", 1.0))
                        for t in tracks
                    ]
                )
            outputs = dict(tracks=track_lists)
        metas = inputs.get("metadata") or [{} for _ in inputs["annotations"]]
        for b, anno in enumerate(inputs["annotations"]):
            meta = metas[b] or {}
            token = str(meta.get("token", ""))
            # waymo tokens are "<seq>_frame_<k>"-style; group by the prefix
            seq = meta.get("seq_id") or token.rsplit("_", 1)[0] or "seq0"
            self._frames.append(
                dict(
                    tracks=outputs["tracks"][b],
                    seq=seq,
                    gt_boxes=np.asarray((anno or {}).get("gt_boxes", np.zeros((0, 9)))),
                    gt_ids=np.asarray((anno or {}).get("track_ids", np.zeros(0, np.int64))),
                    gt_labels=np.asarray((anno or {}).get("labels", np.zeros(0, np.int64))),
                    gt_difficulty=np.asarray(
                        (anno or {}).get("difficulty", np.zeros(0, np.int8))
                    ),
                )
            )

    def evaluate(self):
        shards = comm.all_gather(self._frames)
        if not comm.is_main_process():
            return {}
        frames = [f for s in shards for f in s]
        accs = {c: MOTAccumulator() for c in self.class_names}
        for f in frames:
            for ci, cname in enumerate(self.class_names):
                trks = [t for t in f["tracks"] if t.get("label") == ci]
                trk_ct = np.asarray([t["translation"][:2] for t in trks]).reshape(-1, 2)
                trk_ids = np.asarray([t["tracking_id"] for t in trks], np.int64)
                gm = f["gt_labels"] == ci + 1
                accs[cname].add_frame(
                    trk_ct, trk_ids, f["gt_boxes"][gm][:, :2], f["gt_ids"][gm]
                )
        out = {}
        motas = []
        for c, acc in accs.items():
            r = acc.summarize()
            out.update({f"tracking/{c}/{k}": v for k, v in r.items()})
            if r["n_gt"]:
                motas.append(r["MOTA"])
        out["tracking/MOTA"] = float(np.mean(motas)) if motas else 0.0

        # official-protocol metric (Hungarian IoU matching, L1/L2, score
        # sweep) when tracks carry full boxes — the primary number; the 2 m
        # CLEAR-MOT above stays as the smoke metric
        have_boxes = any(
            t.get("box") is not None for f in frames for t in f["tracks"]
        )
        if have_boxes:
            from efg_tpu_torch.evaluator.waymo_tracking import WaymoTrackingMetric

            thr = {c: (0.7 if c.upper() == "VEHICLE" else 0.5) for c in self.class_names}
            wm = WaymoTrackingMetric(self.class_names, thr)
            for f in frames:
                trks = [t for t in f["tracks"] if t.get("box") is not None]
                pb = np.asarray([np.concatenate([t["box"][:6], t["box"][-1:]]) for t in trks]).reshape(-1, 7)
                ps = np.asarray([t.get("score", 1.0) for t in trks], np.float64)
                pl = np.asarray([int(t["label"]) + 1 for t in trks], np.int64)
                pt = np.asarray([int(t["tracking_id"]) for t in trks], np.int64)
                gb = f["gt_boxes"]
                gb7 = (
                    np.concatenate([gb[:, :6], gb[:, -1:]], axis=1)
                    if gb.shape[1] >= 7
                    else np.zeros((0, 7))
                )
                gd = f["gt_difficulty"]
                if len(gd) != len(gb7):
                    gd = np.ones(len(gb7), np.int8)
                wm.add_frame(
                    f["seq"], pb, ps, pl, pt, gb7, f["gt_labels"], f["gt_ids"], gd
                )
            res = wm.compute()
            for key, r in res.items():
                out.update({f"tracking_official/{key}/{k}": v for k, v in r.items()})
            l2 = [
                r["MOTA"] for key, r in res.items()
                if key.endswith("_L2") and r["n_gt"]
            ]
            if l2:
                out["tracking_official/MOTA_L2"] = float(np.mean(l2))
        return out
