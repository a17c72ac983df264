"""Official-protocol Waymo detection metric core (a port of
`efg_tpu/evaluator/waymo_official.py`, host-side numpy).

Mirrors the `waymo_open_dataset` detection metrics:

- breakdown OBJECT_TYPE, difficulty levels {1, 2}
- matcher TYPE_HUNGARIAN: per frame and score cutoff, a maximum-total-IoU
  assignment over pairs with IoU ≥ threshold (0.7 vehicle / 0.5 pedestrian
  / 0.5 cyclist, 3D IoU)
- score cutoffs 0.00, 0.01, …, 0.99, 1.0 (101 samples); precision/recall
  accumulated per cutoff across frames
- AP = Σ Δrecall · precision over the cutoff-sampled curve after
  enforcing a non-increasing precision envelope, with recall gaps larger
  than `max_recall_delta` = 0.05 filled conservatively at the next
  (lower-precision) sample — the proto's "insert additional p/r points"
  rule
- APH = same with TP contributions weighted by heading accuracy
  max(0, 1 − |Δθ wrapped to (−π, π]| / π)
- LEVEL_1 = GTs with difficulty 1 (difficulty-2 GTs can still absorb
  matches; those predictions are ignored — neither TP nor FP);
  LEVEL_2 = all GTs. Following the reference's decoder convention
  (`waymo_decoder.py` / `create_data.py`), a GT is difficulty 2 if its
  label says so OR it has < 5 lidar points.

Speed: matching decomposes into connected components of the thresholded
IoU graph (components are tiny in practice), and only unique score-prefix
sizes are matched (cutoffs that admit the same prediction set share one
matching). The greedy all-point core in `det3d_metrics.py` remains as the
fast smoke-path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from efg_tpu_torch.evaluator.det3d_metrics import _bev_iou_matrix

NUM_CUTOFFS = 101
MAX_RECALL_DELTA = 0.05


def score_cutoffs() -> np.ndarray:
    """0.00 … 0.99, 1.0 — the reference's explicit config."""
    return np.concatenate([np.arange(100) * 0.01, [1.0]]).astype(np.float64)


def _heading_accuracy(pred_yaw: np.ndarray, gt_yaw: np.ndarray) -> np.ndarray:
    diff = np.abs(pred_yaw - gt_yaw) % (2 * np.pi)
    diff = np.minimum(diff, 2 * np.pi - diff)
    return np.maximum(0.0, 1.0 - diff / np.pi)


def hungarian_match(iou: np.ndarray, threshold: float) -> np.ndarray:
    """Maximum-total-IoU assignment over pairs with IoU ≥ threshold.

    Returns match[j] = matched prediction index per GT j, or -1. Exact:
    decomposes the thresholded bipartite graph into connected components
    and solves each with `linear_sum_assignment` (zero weight for
    sub-threshold pairs; such pairs are dropped afterwards, which cannot
    lower the total weight).
    """
    n, m = iou.shape
    match = np.full(m, -1, np.int64)
    if n == 0 or m == 0:
        return match
    ok = iou >= threshold
    if not ok.any():
        return match

    # union-find over preds (0..n-1) and gts (n..n+m-1)
    parent = np.arange(n + m)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    pi, gj = np.nonzero(ok)
    for a, b in zip(pi, gj + n):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    comp: Dict[int, List[int]] = {}
    for a in set(pi.tolist()) | set((gj + n).tolist()):
        comp.setdefault(find(a), []).append(a)

    for nodes in comp.values():
        preds = [a for a in nodes if a < n]
        gts = [a - n for a in nodes if a >= n]
        if len(preds) == 1 and len(gts) == 1:
            match[gts[0]] = preds[0]
            continue
        sub = iou[np.ix_(preds, gts)]
        sub = np.where(sub >= threshold, sub, 0.0)
        ri, cj = linear_sum_assignment(-sub)
        for a, b in zip(ri, cj):
            if sub[a, b] > 0:
                match[gts[b]] = preds[a]
    return match


class OfficialAccumulator:
    """Per-(class, level) cutoff-sampled TP/FP/FN/heading accumulator."""

    def __init__(self, iou_threshold: float, level: int):
        self.thr = iou_threshold
        self.level = level
        self.cutoffs = score_cutoffs()
        self.tp = np.zeros(NUM_CUTOFFS, np.float64)
        self.fp = np.zeros(NUM_CUTOFFS, np.float64)
        self.fn = np.zeros(NUM_CUTOFFS, np.float64)
        self.hsum = np.zeros(NUM_CUTOFFS, np.float64)

    def add_frame(
        self,
        pred_boxes: np.ndarray,  # [N, 7]
        pred_scores: np.ndarray,
        gt_boxes: np.ndarray,  # [M, 7]
        gt_in_level: np.ndarray,  # [M] bool (L1: difficulty-1 only)
    ):
        m = gt_boxes.shape[0]
        n_level = int(gt_in_level.sum())
        order = np.argsort(-pred_scores, kind="stable")
        pred_boxes = pred_boxes[order]
        pred_scores = pred_scores[order]
        n = pred_boxes.shape[0]

        # number of predictions admitted at each cutoff
        counts = np.searchsorted(-pred_scores, -self.cutoffs, side="right")
        if m == 0:
            self.fp += counts
            return
        self.fn += n_level  # corrected per cutoff below via tp
        if n == 0:
            return

        iou = _bev_iou_matrix(pred_boxes, gt_boxes)
        hacc_cache: Dict[int, np.ndarray] = {}

        prev_k = -1
        for ci in range(NUM_CUTOFFS - 1, -1, -1):
            k = int(counts[ci])
            if k != prev_k:
                match = hungarian_match(iou[:k], self.thr)
                matched = match >= 0
                tp_mask = matched & gt_in_level
                ignored_preds = set(match[matched & ~gt_in_level].tolist())
                tp = int(tp_mask.sum())
                fp = k - tp - len(ignored_preds)
                if tp:
                    js = np.nonzero(tp_mask)[0]
                    h = _heading_accuracy(
                        pred_boxes[match[js], 6], gt_boxes[js, 6]
                    ).sum()
                else:
                    h = 0.0
                prev_k = k
            self.tp[ci] += tp
            self.fp[ci] += fp
            self.fn[ci] -= tp  # n_level added above; FN = n_level - TP
            self.hsum[ci] += h

    def compute(self) -> Dict[str, float]:
        denom_p = self.tp + self.fp
        precision = np.where(denom_p > 0, self.tp / np.maximum(denom_p, 1), 0.0)
        ph = np.where(denom_p > 0, self.hsum / np.maximum(denom_p, 1), 0.0)
        denom_r = self.tp + self.fn
        if denom_r.max() <= 0:
            return {"AP": float("nan"), "APH": float("nan")}
        recall = np.where(denom_r > 0, self.tp / np.maximum(denom_r, 1), 0.0)
        return {
            "AP": compute_ap(precision, recall),
            "APH": compute_ap(ph, recall),
        }


def compute_ap(
    precision: np.ndarray,
    recall: np.ndarray,
    max_recall_delta: float = MAX_RECALL_DELTA,
) -> float:
    """Cutoff-sampled AP, Waymo style.

    Points are indexed by ascending score cutoff (recall non-increasing).
    A non-increasing precision envelope is enforced w.r.t. recall, recall
    gaps > max_recall_delta are filled at the gap's low-precision side
    (conservative interpolation per metrics.proto), and the curve is
    integrated as Σ Δr · p.
    """
    # sort by recall ascending; drop to unique recalls keeping best precision
    r = recall[::-1].astype(np.float64)
    p = precision[::-1].astype(np.float64)
    # precision envelope: p(r) := max precision at any recall ≥ r
    p = np.maximum.accumulate(p[::-1])[::-1]

    ap = 0.0
    # seed the running precision from the first (highest-cutoff) sampled
    # precision, NOT 1.0 — the official curve only interpolates from
    # sampled precisions, so gap filling must never exceed observed values
    prev_r, prev_p = 0.0, (float(p[0]) if len(p) else 0.0)
    for ri, pi in zip(r, p):
        delta = ri - prev_r
        if delta <= 0:
            prev_p = max(prev_p, pi)
            continue
        if delta > max_recall_delta:
            # conservative fill: the unsampled span beyond max_recall_delta
            # is credited at this (lower) precision only
            ap += max_recall_delta * max(prev_p, pi) + (delta - max_recall_delta) * pi
        else:
            ap += delta * pi
        prev_r, prev_p = ri, pi
    return float(ap)


class WaymoOfficialCalculator:
    """AP/APH over classes × difficulty levels, official protocol.

    Drop-in interface twin of `det3d_metrics.DetectionAPCalculator`.
    """

    def __init__(self, class_names: Sequence[str], iou_thresholds: Dict[str, float]):
        self.class_names = list(class_names)
        self.iou_thresholds = iou_thresholds
        self.reset()

    def reset(self):
        self.cells = {
            (c, lvl): OfficialAccumulator(self.iou_thresholds[c], 1 if lvl == "L1" else 2)
            for c in self.class_names
            for lvl in ("L1", "L2")
        }

    def add_frame(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_labels: np.ndarray,  # 1-based into class_names
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_difficulty: Optional[np.ndarray] = None,
        gt_num_points: Optional[np.ndarray] = None,
    ):
        n_gt = gt_boxes.shape[0]
        if gt_difficulty is None:
            gt_difficulty = np.zeros(n_gt, np.int64)
        if gt_num_points is None:
            gt_num_points = np.full(n_gt, 100, np.int64)
        is_l1 = (gt_difficulty < 2) & (gt_num_points >= 5)
        for ci, cname in enumerate(self.class_names):
            pm = pred_labels == ci + 1
            gm = gt_labels == ci + 1
            gb = gt_boxes[gm]
            for lvl, inc in (("L1", is_l1[gm]), ("L2", np.ones(int(gm.sum()), bool))):
                self.cells[(cname, lvl)].add_frame(
                    pred_boxes[pm], pred_scores[pm], gb, inc
                )

    def compute(self) -> Dict[str, float]:
        out = {}
        for (cname, lvl), acc in self.cells.items():
            res = acc.compute()
            out[f"{cname}/{lvl}/AP"] = res["AP"]
            out[f"{cname}/{lvl}/APH"] = res["APH"]
        return out
