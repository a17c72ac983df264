"""3D detection AP/APH metric core, greedy matching (a port of
`efg_tpu/evaluator/det3d_metrics.py`, host-side numpy).

- per-class rotated 3D IoU matching, greedy by descending score
- AP = area under the precision-envelope PR curve (all-point interpolation)
- APH = same with each TP weighted by heading accuracy
  1 − |Δθ wrapped to [0, π]| / π  (Waymo's definition)
- L1/L2 difficulty breakdown: L2 = all GTs; L1 = GTs with difficulty < 2
  and > 5 points. Predictions matched to excluded GTs are ignored
  (neither TP nor FP).

The official protocol (Hungarian matching, cutoff-sampled AP) is
`waymo_official.py`; this greedy core is the fast path
(`trainer.waymo_metric: greedy`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from efg_tpu_torch.ops.iou_rotated import iou_3d


def _bev_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Rotated 3D IoU [N, M] of 7-column boxes, computed on the CPU in f32
    whatever device the model ran on, as efg_tpu pins it to its host CPU
    device: the metric is host code, and its matches do not depend on a
    device's float order."""
    if pred.shape[0] == 0 or gt.shape[0] == 0:
        return np.zeros((pred.shape[0], gt.shape[0]), np.float32)
    return iou_3d(torch.from_numpy(np.ascontiguousarray(pred, np.float32)),
                  torch.from_numpy(np.ascontiguousarray(gt, np.float32))).numpy()


def _heading_accuracy(pred_yaw: np.ndarray, gt_yaw: np.ndarray) -> np.ndarray:
    diff = np.abs(pred_yaw - gt_yaw) % (2 * np.pi)
    diff = np.minimum(diff, 2 * np.pi - diff)
    return 1.0 - diff / np.pi


def _average_precision(tp_weights: np.ndarray, is_tp: np.ndarray, num_gt: int) -> float:
    """All-point interpolated AP from score-sorted TP indicators.

    tp_weights: per-detection contribution when TP (1 for AP, heading
    accuracy for APH); is_tp: boolean; detections already sorted by score
    descending; ignored detections must be removed beforehand."""
    if num_gt == 0:
        return float("nan")
    if len(is_tp) == 0:
        return 0.0
    tp_cum = np.cumsum(np.where(is_tp, tp_weights, 0.0))
    fp_cum = np.cumsum(~is_tp)
    tp_count = np.cumsum(is_tp)
    recall = tp_count / num_gt
    precision = tp_cum / np.maximum(tp_count + fp_cum, 1e-9)
    # precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # integrate over recall
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([precision[:1], precision])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


class APAccumulator:
    """Accumulates per-frame matches for one (class, difficulty) cell."""

    def __init__(self):
        self.scores: List[np.ndarray] = []
        self.is_tp: List[np.ndarray] = []
        self.heading_acc: List[np.ndarray] = []
        self.num_gt = 0

    def add_frame(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        gt_boxes: np.ndarray,
        gt_include: np.ndarray,
        iou_threshold: float,
    ):
        """gt_include: bool — GTs counted for this difficulty; excluded GTs
        can still absorb matches (those predictions are then ignored)."""
        self.num_gt += int(gt_include.sum())
        if pred_boxes.shape[0] == 0:
            return
        order = np.argsort(-pred_scores)
        pred_boxes = pred_boxes[order]
        pred_scores = pred_scores[order]
        iou = _bev_iou_matrix(pred_boxes, gt_boxes) if gt_boxes.shape[0] else np.zeros((len(pred_boxes), 0))

        taken = np.zeros(gt_boxes.shape[0], bool)
        is_tp = np.zeros(len(pred_boxes), bool)
        ignored = np.zeros(len(pred_boxes), bool)
        hacc = np.zeros(len(pred_boxes), np.float32)
        for i in range(len(pred_boxes)):
            if iou.shape[1] == 0:
                continue
            cand = np.where(~taken & (iou[i] >= iou_threshold))[0]
            if cand.size == 0:
                continue
            j = cand[np.argmax(iou[i, cand])]
            taken[j] = True
            if gt_include[j]:
                is_tp[i] = True
                hacc[i] = _heading_accuracy(
                    np.asarray(pred_boxes[i, -1]), np.asarray(gt_boxes[j, -1])
                )
            else:
                ignored[i] = True
        keep = ~ignored
        self.scores.append(pred_scores[keep])
        self.is_tp.append(is_tp[keep])
        self.heading_acc.append(hacc[keep])

    def compute(self) -> Dict[str, float]:
        if not self.scores:
            return {"AP": 0.0 if self.num_gt else float("nan"), "APH": 0.0 if self.num_gt else float("nan")}
        scores = np.concatenate(self.scores)
        is_tp = np.concatenate(self.is_tp)
        hacc = np.concatenate(self.heading_acc)
        order = np.argsort(-scores)
        is_tp, hacc = is_tp[order], hacc[order]
        return {
            "AP": _average_precision(np.ones_like(hacc), is_tp, self.num_gt),
            "APH": _average_precision(hacc, is_tp, self.num_gt),
        }


class DetectionAPCalculator:
    """AP/APH over classes × difficulty levels."""

    def __init__(self, class_names: Sequence[str], iou_thresholds: Dict[str, float]):
        self.class_names = list(class_names)
        self.iou_thresholds = iou_thresholds
        self.reset()

    def reset(self):
        self.cells = {
            (c, lvl): APAccumulator()
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
        is_l1 = (gt_difficulty < 2) & (gt_num_points > 5)
        for ci, cname in enumerate(self.class_names):
            thr = self.iou_thresholds[cname]
            pm = pred_labels == ci + 1
            gm = gt_labels == ci + 1
            gb = gt_boxes[gm]
            for lvl, inc in (("L1", is_l1[gm]), ("L2", np.ones(int(gm.sum()), bool))):
                self.cells[(cname, lvl)].add_frame(
                    pred_boxes[pm], pred_scores[pm], gb, inc, thr
                )

    def compute(self) -> Dict[str, float]:
        out = {}
        for (cname, lvl), acc in self.cells.items():
            r = acc.compute()
            out[f"{cname}/{lvl}/AP"] = r["AP"]
            out[f"{cname}/{lvl}/APH"] = r["APH"]
        return out
