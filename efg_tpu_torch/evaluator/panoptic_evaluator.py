"""Panoptic Quality evaluator (port of
`efg_tpu/evaluator/panoptic_evaluator.py`).

PQ / SQ / RQ straight from per-image (prediction, GT) segment-id maps and
their category dicts, without panopticapi:

    PQ = Σ_TP IoU / (|TP| + ½|FP| + ½|FN|), matched at IoU > 0.5,

void excluded, crowd GT segments ignored, a prediction mostly on void or
on a same-class crowd region not counted as a false positive.
`assemble_panoptic` turns Mask2Former's `predict_panoptic` outputs (the
winning-query map, labels, keep flags) into segments on the host; the
evaluator cuts the fixed canvas back to the image (`image_size` at mask
scale) and resizes the map to the GT's resolution with
`cv2.INTER_NEAREST`. Every rank's images are gathered and rank 0
evaluates.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator
from efg_tpu_torch.evaluator.registry import EVALUATORS
from efg_tpu_torch.utils import distributed as comm

VOID = 0


def pq_single_image(pan_pred: np.ndarray, pred_segments: Dict[int, int], pan_gt: np.ndarray,
                    gt_segments: Dict[int, int], gt_iscrowd: Dict[int, bool],
                    stats: Dict[int, np.ndarray]) -> None:
    """Accumulate per-category [iou_sum, tp, fp, fn] into `stats`."""
    combined = pan_gt.astype(np.int64) * (2 ** 24) + pan_pred.astype(np.int64)
    ids, counts = np.unique(combined, return_counts=True)
    inter = {(int(c // 2 ** 24), int(c % 2 ** 24)): int(n) for c, n in zip(ids, counts)}

    gt_areas = {s: 0 for s in gt_segments}
    pred_areas = {s: 0 for s in pred_segments}
    for (g, p), cnt in inter.items():
        if g in gt_areas:
            gt_areas[g] += cnt
        if p in pred_areas:
            pred_areas[p] += cnt

    matched_gt, matched_pred = set(), set()
    for (g, p), cnt in inter.items():
        if g not in gt_segments or p not in pred_segments:
            continue
        if gt_iscrowd.get(g, False) or gt_segments[g] != pred_segments[p]:
            continue
        union = gt_areas[g] + pred_areas[p] - cnt - inter.get((VOID, p), 0)
        iou = cnt / max(union, 1)
        if iou > 0.5:
            st = stats.setdefault(gt_segments[g], np.zeros(4))
            st[0] += iou
            st[1] += 1
            matched_gt.add(g)
            matched_pred.add(p)

    crowd_by_cat = {}
    for g, cat in gt_segments.items():
        if g in matched_gt:
            continue
        if gt_iscrowd.get(g, False):
            crowd_by_cat[cat] = g
            continue
        stats.setdefault(cat, np.zeros(4))[3] += 1  # FN
    for p, cat in pred_segments.items():
        if p in matched_pred:
            continue
        void_overlap = inter.get((VOID, p), 0)
        if cat in crowd_by_cat:
            void_overlap += inter.get((crowd_by_cat[cat], p), 0)
        if void_overlap / max(pred_areas.get(p, 1), 1) > 0.5:
            continue
        stats.setdefault(cat, np.zeros(4))[2] += 1  # FP


def summarize_pq(stats: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The category means of PQ, SQ and RQ over categories seen."""
    pqs, sqs, rqs = [], [], []
    for _, (iou_sum, tp, fp, fn) in sorted(stats.items()):
        if tp + fp + fn == 0:
            continue
        sq = iou_sum / tp if tp else 0.0
        rq = tp / (tp + 0.5 * fp + 0.5 * fn)
        pqs.append(sq * rq)
        sqs.append(sq)
        rqs.append(rq)
    if not pqs:
        return {"PQ": 0.0, "SQ": 0.0, "RQ": 0.0, "n_categories": 0}
    return {"PQ": float(np.mean(pqs)), "SQ": float(np.mean(sqs)), "RQ": float(np.mean(rqs)),
            "n_categories": len(pqs)}


def assemble_panoptic(pan_seg_q, labels, keep, thing_ids):
    """The segment map and {segment id: class} of one image from
    `predict_panoptic`'s winning-query map (query + 1, 0 void), labels and
    keep flags: kept queries in order take dense ids; a stuff class's
    later queries join its first segment."""
    out = np.zeros(pan_seg_q.shape, np.int32)
    segments, stuff_memory = {}, {}
    next_id = 1
    for q in np.nonzero(np.asarray(keep))[0]:
        m = pan_seg_q == (q + 1)
        if not m.any():
            continue
        cls = int(labels[q])
        if cls not in thing_ids and cls in stuff_memory:
            out[m] = stuff_memory[cls]
            continue
        if cls not in thing_ids:
            stuff_memory[cls] = next_id
        out[m] = next_id
        segments[next_id] = cls
        next_id += 1
    return out, segments


@EVALUATORS.register()
class PanopticEvaluator(DatasetEvaluator):
    def __init__(self, config, dataset):
        self.thing_ids = set(getattr(dataset, "thing_contiguous_ids", set()))
        self._items: List[dict] = []

    def reset(self):
        self._items = []

    def process(self, inputs, outputs):
        """outputs: assembled `pan_pred` [H, W] + `pred_segments` per image,
        or `predict_panoptic`'s fields (`pan_seg`, `pan_labels`,
        `pan_keep`), assembled here, cut to the image and resized to the
        GT; inputs' annotations carry `pan_gt`, `gt_segments` and
        `gt_iscrowd_seg`."""
        for b in range(len(inputs["annotations"])):
            anno = inputs["annotations"][b] or {}
            if "pan_pred" in outputs:
                pan_pred = np.asarray(outputs["pan_pred"][b])
                pred_segments = outputs["pred_segments"][b]
            else:
                ps = np.asarray(outputs["pan_seg"][b])
                pan_pred, pred_segments = assemble_panoptic(
                    ps, np.asarray(outputs["pan_labels"][b]), np.asarray(outputs["pan_keep"][b]),
                    self.thing_ids)
                meta = (inputs.get("metadata") or [{}] * (b + 1))[b] or {}
                gt_hw = np.asarray(anno["pan_gt"]).shape
                if "images" in inputs and "image_size" in meta:
                    # the image's part of the fixed canvas, at mask scale
                    stride = max(inputs["images"].shape[1] // ps.shape[0], 1)
                    pan_pred = pan_pred[:-(-int(meta["image_size"][0]) // stride),
                                        :-(-int(meta["image_size"][1]) // stride)]
                if pan_pred.shape != gt_hw:
                    import cv2

                    pan_pred = cv2.resize(pan_pred, (gt_hw[1], gt_hw[0]),
                                          interpolation=cv2.INTER_NEAREST)
            self._items.append(dict(pan_pred=pan_pred, pred_segments=pred_segments,
                                    pan_gt=np.asarray(anno["pan_gt"]),
                                    gt_segments=anno["gt_segments"],
                                    gt_iscrowd=anno.get("gt_iscrowd_seg", {})))

    def evaluate(self):
        shards = comm.all_gather(self._items)
        if not comm.is_main_process():
            return {}
        stats: Dict[int, np.ndarray] = {}
        for shard in shards:
            for it in shard:
                pq_single_image(it["pan_pred"], it["pred_segments"], it["pan_gt"],
                                it["gt_segments"], it["gt_iscrowd"], stats)
        return {f"panoptic/{k}": v for k, v in summarize_pq(stats).items()}
