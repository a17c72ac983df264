"""Official-protocol Waymo tracking metric core (host-side numpy; a copy
of `efg_tpu/evaluator/waymo_tracking.py`).

Mirrors the `waymo_open_dataset` tracking metrics the reference shells out
to (the reference's `playground/tracking.3d/waymo/trajectoryformer/
trajectoryformer.centerpoint/track_evaluator.py:15-120` writes prediction /
GT `metrics_pb2.Objects` files and runs the official
`compute_tracking_metrics_main`): CLEAR-MOT over Hungarian IoU matching,

- per-frame maximum-total-IoU Hungarian assignment at the DETECTION IoU
  thresholds (0.7 vehicle / 0.5 pedestrian / 0.5 cyclist) — the same
  matcher as the detection metric (`waymo_official.hungarian_match`), NOT
  a center-distance gate,
- MISS = unmatched GTs, FP = unmatched predictions, MISMATCH = a GT whose
  matched track id differs from the id it was last matched to within the
  same sequence,
- MOTA = 1 − (miss + fp + mismatch) / num_gts,
  MOTP = mean(1 − IoU) over matches (the official matching-cost average),
- a score-cutoff sweep; the reported operating point is the cutoff
  maximizing MOTA (the official tool's per-cutoff table collapsed the same
  way),
- LEVEL_1 (difficulty-1 GTs; difficulty-2 GTs absorb matches but their
  predictions are ignored) and LEVEL_2 (all GTs), as in the detection
  metric.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from efg_tpu_torch.evaluator.det3d_metrics import _bev_iou_matrix
from efg_tpu_torch.evaluator.waymo_official import hungarian_match

DEFAULT_CUTOFFS = np.arange(0.0, 1.0, 0.05)


class _SeqFrames:
    __slots__ = ("frames",)

    def __init__(self):
        self.frames: List[dict] = []


class WaymoTrackingMetric:
    """Accumulate per-frame tracked boxes + GTs, compute official-style
    MOTA/MOTP per class × level at the best score cutoff."""

    def __init__(
        self,
        class_names: Sequence[str],
        iou_thresholds: Dict[str, float],
        cutoffs: np.ndarray = DEFAULT_CUTOFFS,
    ):
        self.class_names = list(class_names)
        self.iou_thresholds = iou_thresholds
        self.cutoffs = np.asarray(cutoffs, np.float64)
        self.reset()

    def reset(self):
        self._seqs: Dict[str, _SeqFrames] = defaultdict(_SeqFrames)

    def add_frame(
        self,
        seq_id,
        pred_boxes: np.ndarray,   # [N, 7] (x y z dx dy dz yaw)
        pred_scores: np.ndarray,  # [N]
        pred_labels: np.ndarray,  # [N] 1-based class ids
        pred_track_ids: np.ndarray,  # [N]
        gt_boxes: np.ndarray,     # [M, 7]
        gt_labels: np.ndarray,    # [M] 1-based
        gt_ids: np.ndarray,       # [M] persistent object ids
        gt_difficulty: np.ndarray,  # [M] 1 or 2
    ):
        self._seqs[seq_id].frames.append(
            dict(
                pb=np.asarray(pred_boxes, np.float64).reshape(-1, 7),
                ps=np.asarray(pred_scores, np.float64).reshape(-1),
                pl=np.asarray(pred_labels).reshape(-1),
                pt=np.asarray(pred_track_ids).reshape(-1),
                gb=np.asarray(gt_boxes, np.float64).reshape(-1, 7),
                gl=np.asarray(gt_labels).reshape(-1),
                gi=np.asarray(gt_ids).reshape(-1),
                gd=np.asarray(gt_difficulty).reshape(-1),
            )
        )

    def _eval_class_level(self, cls_idx: int, level: int) -> Dict[str, float]:
        cls_id = cls_idx + 1
        thr = self.iou_thresholds[self.class_names[cls_idx]]
        nc = len(self.cutoffs)
        miss = np.zeros(nc)
        fp = np.zeros(nc)
        mism = np.zeros(nc)
        n_match = np.zeros(nc)
        cost_sum = np.zeros(nc)
        n_gt = 0

        for seq in self._seqs.values():
            # per-cutoff association memory: gt id → last matched track id
            last: List[Dict[int, int]] = [dict() for _ in range(nc)]
            for f in seq.frames:
                pm = f["pl"] == cls_id
                gm = f["gl"] == cls_id
                pb, ps, pt = f["pb"][pm], f["ps"][pm], f["pt"][pm]
                gb, gi, gd = f["gb"][gm], f["gi"][gm], f["gd"][gm]
                in_level = (gd <= 1) if level == 1 else np.ones(len(gb), bool)
                n_gt_lvl = int(in_level.sum())
                n_gt += n_gt_lvl  # counted once; per-cutoff identical

                order = np.argsort(-ps, kind="stable")
                pb, ps, pt = pb[order], ps[order], pt[order]
                counts = np.searchsorted(-ps, -self.cutoffs, side="right")
                iou = _bev_iou_matrix(pb, gb) if len(pb) and len(gb) else None

                match_cache: Dict[int, np.ndarray] = {}
                for ci in range(nc):
                    k = int(counts[ci])
                    if iou is None:
                        match = np.full(len(gb), -1, np.int64)
                    elif k in match_cache:
                        match = match_cache[k]
                    else:
                        match = hungarian_match(iou[:k], thr)
                        match_cache[k] = match
                    matched = match >= 0
                    tp_mask = matched & in_level
                    # matches to out-of-level GTs are ignored predictions
                    # (neither TP nor FP) — same rule as the detection metric
                    ignored = set(match[matched & ~in_level].tolist())
                    miss[ci] += n_gt_lvl - int(tp_mask.sum())
                    fp[ci] += k - int(tp_mask.sum()) - len(ignored)
                    for j in np.nonzero(tp_mask)[0]:
                        tid = int(pt[match[j]])
                        gid = int(gi[j])
                        prev = last[ci].get(gid)
                        if prev is not None and prev != tid:
                            mism[ci] += 1
                        last[ci][gid] = tid
                        n_match[ci] += 1
                        cost_sum[ci] += 1.0 - iou[match[j], j]

        if n_gt == 0:
            return dict(MOTA=float("nan"), MOTP=float("nan"), miss=0.0,
                        mismatch=0.0, fp=0.0, score_cutoff=0.0, n_gt=0)
        mota = 1.0 - (miss + fp + mism) / n_gt
        best = int(np.argmax(mota))
        return dict(
            MOTA=float(mota[best]),
            MOTP=float(cost_sum[best] / max(n_match[best], 1)),
            miss=float(miss[best] / n_gt),
            mismatch=float(mism[best] / n_gt),
            fp=float(fp[best] / n_gt),
            score_cutoff=float(self.cutoffs[best]),
            n_gt=int(n_gt),
        )

    def compute(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for ci, name in enumerate(self.class_names):
            for level in (1, 2):
                out[f"{name}_L{level}"] = self._eval_class_level(ci, level)
        return out
