"""Self-contained numpy COCO detection evaluation (a copy of
`efg_tpu/evaluator/coco_eval_np.py`, with one deviation: a threshold at
which every detection of a category is ignored while the area range holds
GT scores AP 0, where efg_tpu raises).

Stands in for pycocotools and the reference's C++ `COCOeval_opt`: the
standard COCO protocol, with 10 IoU thresholds (.5:.05:.95), 101-point
precision interpolation, area ranges (all/small/medium/large), maxDets
100, greedy per-image matching with crowd regions as ignore; box, mask
(segm), keypoint (OKS) and class-agnostic proposal AR evaluation.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def iou_xyxy_np(a: np.ndarray, b: np.ndarray, iscrowd=None) -> np.ndarray:
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    if iscrowd is not None:
        # crowd: IoU is intersection over det area (pycocotools semantics)
        union = np.where(iscrowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-9)


def mask_iou_np(a: np.ndarray, b: np.ndarray, iscrowd=None) -> np.ndarray:
    """IoU between flat binary masks a [N, HW], b [M, HW] (uint8/bool).
    Intersections via one BLAS matmul (reference capability:
    `efg/evaluator/coco_evaluator.py:485-523` segm path / pycocotools
    maskUtils.iou; crowd = intersection over det area)."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    af = a.reshape(a.shape[0], -1).astype(np.float32)
    bf = b.reshape(b.shape[0], -1).astype(np.float32)
    inter = af @ bf.T
    area_a = af.sum(1)
    area_b = bf.sum(1)
    union = area_a[:, None] + area_b[None, :] - inter
    if iscrowd is not None:
        union = np.where(iscrowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-9)


# COCO person-keypoint per-keypoint falloff constants (pycocotools
# `COCOeval.__init__` kpt_oks_sigmas; reference passes
# `config.dataset.test.keypoint_oks_sigmas` through, `coco_evaluator.py:91`)
KPT_OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]
) / 10.0


def oks_np(det_kpts: np.ndarray, gt_kpts: np.ndarray, gt_boxes: np.ndarray,
           gt_areas: np.ndarray, sigmas: np.ndarray = None) -> np.ndarray:
    """Object-keypoint-similarity matrix [N_det, M_gt] (pycocotools
    `computeOks` semantics): per keypoint exp(-d²/(2·area·(2σ)²)),
    averaged over the GT's labeled keypoints; a GT with no labeled
    keypoints falls back to distances clamped against its box expanded
    by 2× on each side."""
    n, m = det_kpts.shape[0], gt_kpts.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m))
    k = det_kpts.shape[1]
    sigmas = KPT_OKS_SIGMAS[:k] if sigmas is None else np.asarray(sigmas)[:k]
    var = (sigmas * 2.0) ** 2  # [K]
    out = np.zeros((n, m))
    xd, yd = det_kpts[..., 0], det_kpts[..., 1]  # [N, K]
    for j in range(m):
        vg = gt_kpts[j, :, 2]
        lab = vg > 0
        if lab.any():
            dx = xd - gt_kpts[j, None, :, 0][0]
            dy = yd - gt_kpts[j, None, :, 1][0]
        else:
            x0, y0, x1, y1 = gt_boxes[j]
            w, h = x1 - x0, y1 - y0
            z0x, z1x = x0 - w, x1 + w
            z0y, z1y = y0 - h, y1 + h
            dx = np.clip(z0x - xd, 0, None) + np.clip(xd - z1x, 0, None)
            dy = np.clip(z0y - yd, 0, None) + np.clip(yd - z1y, 0, None)
            lab = np.ones(k, bool)
        e = (dx**2 + dy**2) / var[None, :] / max(gt_areas[j], 1e-9) / 2.0
        out[:, j] = np.exp(-e[:, lab]).sum(axis=1) / lab.sum()
    return out


def _match_image(iou, det_scores, gt_ignore, iou_thrs):
    """Greedy score-ordered matching over a precomputed det×gt IoU matrix
    (rows already score-sorted). Returns (tp [T, D], ignore_det [T, D],
    score order)."""
    order = np.argsort(-det_scores)
    iou = iou[order]
    d = iou.shape[0]
    g = len(gt_ignore)
    t = len(iou_thrs)
    tp = np.zeros((t, d), bool)
    ign = np.zeros((t, d), bool)
    if g:
        # non-ignored first (pycocotools sorts gt by ignore flag)
        gt_order = np.argsort(gt_ignore.astype(np.int8), kind="stable")
        for ti, thr in enumerate(iou_thrs):
            taken = np.zeros(g, bool)
            for di in range(d):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in gt_order:
                    if taken[gi] and not gt_ignore[gi]:
                        continue
                    if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                        break  # can't beat a real match with an ignore
                    if iou[di, gi] < best_iou:
                        continue
                    best, best_iou = gi, iou[di, gi]
                if best == -1:
                    continue
                if gt_ignore[best]:
                    ign[ti, di] = True
                else:
                    taken[best] = True
                    tp[ti, di] = True
    return tp, ign, order


class COCOEvalNP:
    """Accumulate per-(image, category) detections and compute COCO APs.

    `iou_type="segm"` evaluates by binary-mask IoU (pass `det_masks` /
    `gt_masks` bitmasks of a common per-image resolution to `add_image`;
    GT areas still come from the annotation `area` field like
    pycocotools). Matches the reference's segm evaluation capability
    (`efg/evaluator/coco_evaluator.py:485-523`)."""

    def __init__(self, max_dets: int = 100, iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm", "keypoints")
        if iou_type == "keypoints" and max_dets == 100:
            max_dets = 20  # pycocotools keypoint default
        self.max_dets = max_dets
        self.iou_type = iou_type
        # frames[(cat)] = list of per-image dicts
        self.frames: Dict[int, List[dict]] = defaultdict(list)

    def add_image(self, cat_id: int, det_boxes, det_scores, gt_boxes,
                  gt_iscrowd, gt_areas, det_masks=None, gt_masks=None,
                  det_keypoints=None, gt_keypoints=None):
        f = dict(
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=np.asarray(det_scores, np.float64).reshape(-1),
            gt_boxes=np.asarray(gt_boxes, np.float64).reshape(-1, 4),
            gt_iscrowd=np.asarray(gt_iscrowd, bool).reshape(-1),
            gt_areas=np.asarray(gt_areas, np.float64).reshape(-1),
        )
        if self.iou_type == "segm":
            dm = np.asarray(det_masks, np.uint8)
            gm = np.asarray(gt_masks, np.uint8)
            f["det_masks"] = dm.reshape(len(f["det_boxes"]), -1)
            f["gt_masks"] = gm.reshape(len(f["gt_boxes"]), -1)
        elif self.iou_type == "keypoints":
            nd, ng = len(f["det_boxes"]), len(f["gt_boxes"])
            f["det_keypoints"] = np.asarray(det_keypoints, np.float64).reshape(nd, -1, 3)
            f["gt_keypoints"] = np.asarray(gt_keypoints, np.float64).reshape(ng, -1, 3)
        self.frames[cat_id].append(f)

    def _eval_for(self, cat_frames, area_rng, max_dets=None):
        """(AP [T], recall-at-maxDets [T]) for one category + area range."""
        max_dets = max_dets or self.max_dets
        t = len(IOU_THRS)
        scores_all, tp_all, ign_all = [], [], []
        num_gt = 0
        for f in cat_frames:
            sc = f["det_scores"]
            order0 = np.argsort(-sc)[:max_dets]
            det = f["det_boxes"][order0]
            sc = sc[order0]

            g_area = f["gt_areas"]
            if g_area.size == 0 and len(f["gt_boxes"]):
                if self.iou_type == "segm":
                    g_area = f["gt_masks"].sum(1).astype(np.float64)
                else:
                    g_area = (
                        np.clip(f["gt_boxes"][:, 2] - f["gt_boxes"][:, 0], 0, None)
                        * np.clip(f["gt_boxes"][:, 3] - f["gt_boxes"][:, 1], 0, None)
                    )
            gt_ignore = f["gt_iscrowd"] | (g_area < area_rng[0]) | (g_area >= area_rng[1])
            if self.iou_type == "keypoints" and len(f["gt_boxes"]):
                # GTs with zero labeled keypoints are ignore regions
                # (pycocotools: gt['ignore'] = k1 == 0)
                gt_ignore = gt_ignore | ~(f["gt_keypoints"][:, :, 2] > 0).any(axis=1)
            num_gt += int((~gt_ignore).sum())

            if self.iou_type == "keypoints":
                iou = oks_np(f["det_keypoints"][order0], f["gt_keypoints"],
                             f["gt_boxes"], g_area)
                # det "area" for the range filter: its box area (dets carry
                # boxes in keypoint results; pycocotools uses the det bbox)
                d_area = (
                    np.clip(det[:, 2] - det[:, 0], 0, None)
                    * np.clip(det[:, 3] - det[:, 1], 0, None)
                )
            elif self.iou_type == "segm":
                dmask = f["det_masks"][order0]
                iou = mask_iou_np(dmask, f["gt_masks"], iscrowd=f["gt_iscrowd"])
                d_area = dmask.sum(1).astype(np.float64)
            else:
                iou = iou_xyxy_np(det, f["gt_boxes"], iscrowd=f["gt_iscrowd"])
                d_area = (
                    np.clip(det[:, 2] - det[:, 0], 0, None)
                    * np.clip(det[:, 3] - det[:, 1], 0, None)
                )
            tp, ign, order = _match_image(iou, sc, gt_ignore, IOU_THRS)
            # dets outside the area range that didn't match a real GT → ignore
            out_of_rng = (d_area[order] < area_rng[0]) | (d_area[order] >= area_rng[1])
            ign = ign | (out_of_rng[None, :] & ~tp)
            scores_all.append(sc[order])
            tp_all.append(tp)
            ign_all.append(ign)

        if num_gt == 0:
            return np.full(t, np.nan), np.full(t, np.nan)
        if not scores_all:
            return np.zeros(t), np.zeros(t)
        scores = np.concatenate(scores_all)
        tp = np.concatenate(tp_all, axis=1)
        ign = np.concatenate(ign_all, axis=1)
        order = np.argsort(-scores)
        tp, ign = tp[:, order], ign[:, order]

        aps = np.zeros(t)
        recs = np.zeros(t)
        for ti in range(t):
            keep = ~ign[ti]
            tps = tp[ti][keep]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            recall = tp_cum / num_gt
            recs[ti] = recall[-1] if len(recall) else 0.0
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            # precision envelope + 101-point interpolation
            precision = np.maximum.accumulate(precision[::-1])[::-1]
            if not len(precision):
                # every detection ignored at this threshold while the range
                # holds GT: AP 0, as pycocotools gives; efg_tpu indexes the
                # empty array and raises IndexError (ROADMAP queue 3 item 14)
                continue
            idx = np.searchsorted(recall, REC_THRS, side="left")
            prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
            prec_at[idx >= len(precision)] = 0.0
            aps[ti] = prec_at.mean()
        return aps, recs

    def _ap_for(self, cat_frames, area_rng) -> np.ndarray:
        return self._eval_for(cat_frames, area_rng)[0]

    def summarize(self) -> Dict[str, float]:
        cats = sorted(self.frames.keys())
        # keypoint protocol has no "small" range (pycocotools kpt params;
        # reference summary keys "AP","AP50","AP75","APm","APl",
        # `coco_evaluator.py:267`)
        rngs = [r for r in AREA_RNGS if not (self.iou_type == "keypoints" and r == "small")]
        per_cat = {
            rng: np.stack([self._ap_for(self.frames[c], AREA_RNGS[rng]) for c in cats])
            for rng in rngs
        }  # [C, T]
        out = {}
        all_ap = per_cat["all"]
        out["AP"] = float(np.nanmean(all_ap))
        out["AP50"] = float(np.nanmean(all_ap[:, 0]))
        out["AP75"] = float(np.nanmean(all_ap[:, 5]))
        if "small" in per_cat:
            out["APs"] = float(np.nanmean(per_cat["small"]))
        out["APm"] = float(np.nanmean(per_cat["medium"]))
        out["APl"] = float(np.nanmean(per_cat["large"]))
        # recall at 1/10/maxDets over all areas (standard COCO AR block)
        for md, name in ((1, "AR1"), (10, "AR10"), (self.max_dets, f"AR{self.max_dets}")):
            rc = np.stack(
                [self._eval_for(self.frames[c], AREA_RNGS["all"], max_dets=md)[1] for c in cats]
            )
            out[name] = float(np.nanmean(rc))
        return out

    def per_category_ap(self) -> Dict[int, float]:
        """cat id → AP(all areas) — the reference's per-category results
        table (`efg/evaluator/coco_evaluator.py:525-545`)."""
        return {
            c: float(np.nanmean(self._ap_for(self.frames[c], AREA_RNGS["all"])))
            for c in sorted(self.frames.keys())
        }

    def summarize_proposals(self, max_dets=(100,)) -> Dict[str, float]:
        """Class-agnostic proposal AR (pycocotools useCats=0). Callers
        add each image ONCE under a single category (labels ignored);
        reports AR + per-area AR at each maxDets."""
        frames = [f for c in sorted(self.frames.keys()) for f in self.frames[c]]
        out = {}
        for md in max_dets:
            _, rc = self._eval_for(frames, AREA_RNGS["all"], max_dets=md)
            out[f"AR@{md}"] = float(np.nanmean(rc))
            for rng in ("small", "medium", "large"):
                _, rca = self._eval_for(frames, AREA_RNGS[rng], max_dets=md)
                out[f"AR{rng[0]}@{md}"] = float(np.nanmean(rca))
        return out
