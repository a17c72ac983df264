"""nuScenes detection evaluator, in-process and devkit-free (a copy of
`efg_tpu/evaluator/nuscenes_evaluator.py`). The reference converts
predictions to global-frame boxes and runs the official `nuscenes-devkit`;
this evaluator computes the official protocol itself:

- per-class AP at center-distance thresholds {0.5, 1, 2, 4} m, with the
  official normalization (integrate precision over recall ∈ [0.1, 1],
  subtract the 0.1 floor, /0.9)
- TP metrics at the 2.0 m threshold: ATE (m), ASE (1−IoU of aligned
  boxes), AOE (rad), AVE (m/s), AAE (1 − attribute accuracy)
- NDS = [5·mAP + Σ_tp (1 − min(1, err))] / 10

Predicted attributes follow the reference's velocity rule + per-class
frequency priors (`efg/evaluator/nuscenes_evaluator.py:136-162`): speed
> 0.2 m/s → vehicle.moving / cycle.with_rider; else pedestrian.standing /
vehicle.stopped (bus); otherwise the most frequent trainset attribute for
the class (`cls_attr_dist`). GT attributes come from the `gt_attrs` info
field (cli/data_preparation/nuscenes/create_data.py); GTs without an
attribute are skipped, as in the devkit. Barrier and traffic cone are
excluded from AAE/AVE (and cone from AOE), matching the devkit's
per-class metric exclusions.

Boxes are compared in the EFG lidar frame (the reference transforms to the
global frame first — a rigid transform per frame, distance-invariant, so
matching is unchanged for frame-local evaluation).
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from efg_tpu_torch.data.datasets.nuscenes import CLS_ATTR_DIST
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator
from efg_tpu_torch.evaluator.registry import EVALUATORS
from efg_tpu_torch.utils import distributed as comm
from efg_tpu_torch.utils.logger import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0


def _aligned_iou_1x1(a: np.ndarray, b: np.ndarray) -> float:
    """Size-only 3D IoU of two boxes placed at the same center, yaw-aligned
    (official ASE definition)."""
    inter = np.prod(np.minimum(a[3:6], b[3:6]))
    union = np.prod(a[3:6]) + np.prod(b[3:6]) - inter
    return float(inter / max(union, 1e-9))


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = abs(a - b) % period
    return min(d, period - d)


def assign_attribute(cname: str, speed: float) -> str:
    """Predicted attribute for a detection: the reference's velocity rule
    with a class-frequency-prior fallback (ref `nuscenes_evaluator.py:
    136-162`)."""
    n = cname.lower()
    if speed > 0.2:
        if n in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if n in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
    else:
        if n == "pedestrian":
            return "pedestrian.standing"
        if n == "bus":
            return "vehicle.stopped"
    dist = CLS_ATTR_DIST.get(n, {})
    return max(dist.items(), key=lambda kv: kv[1])[0] if dist else ""


class _ClassAccumulator:
    def __init__(self, yaw_period: float = 2 * np.pi, use_orient: bool = True,
                 use_vel: bool = True, use_attr: bool = True):
        # official per-class rules (devkit): barriers match modulo pi and
        # have no velocity/attribute error; traffic cones have no
        # orientation/velocity/attribute error
        self.frames: List[dict] = []
        self.yaw_period = yaw_period
        self.use_orient = use_orient
        self.use_vel = use_vel
        self.use_attr = use_attr

    def ap_and_tp(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        num_gt = sum(f["gt"].shape[0] for f in self.frames)
        if num_gt == 0:
            return {f"AP@{t}": float("nan") for t in DIST_THRESHOLDS}
        for thr in DIST_THRESHOLDS:
            scores, tps = [], []
            errs = dict(trans=[], scale=[], orient=[], vel=[], attr=[])
            for f in self.frames:
                det, sc, gt = f["det"], f["scores"], f["gt"]
                det_attr = f.get("det_attr")
                gt_attr = f.get("gt_attr")
                order = np.argsort(-sc)
                det, sc = det[order], sc[order]
                if det_attr is not None and len(det_attr):
                    det_attr = np.asarray(det_attr)[order]
                taken = np.zeros(gt.shape[0], bool)
                tp = np.zeros(len(det), bool)
                for i in range(len(det)):
                    if gt.shape[0] == 0:
                        break
                    d2 = np.linalg.norm(gt[:, :2] - det[i, :2], axis=1)
                    d2[taken] = np.inf
                    j = int(np.argmin(d2))
                    if d2[j] < thr:
                        taken[j] = True
                        tp[i] = True
                        if thr == TP_THRESHOLD:
                            errs["trans"].append(float(np.linalg.norm(gt[j, :2] - det[i, :2])))
                            errs["scale"].append(1.0 - _aligned_iou_1x1(det[i], gt[j]))
                            if self.use_orient:
                                errs["orient"].append(
                                    _yaw_diff(det[i, -1], gt[j, -1],
                                              period=self.yaw_period)
                                )
                            if self.use_vel:
                                errs["vel"].append(float(np.linalg.norm(gt[j, 6:8] - det[i, 6:8])))
                            # devkit: attr error only over TPs whose GT
                            # carries an attribute
                            if (self.use_attr and gt_attr is not None
                                    and j < len(gt_attr) and gt_attr[j]):
                                pred = det_attr[i] if det_attr is not None and i < len(det_attr) else ""
                                errs["attr"].append(0.0 if pred == gt_attr[j] else 1.0)
                scores.append(sc)
                tps.append(tp)
            scores = np.concatenate(scores) if scores else np.zeros(0)
            tps = np.concatenate(tps) if tps else np.zeros(0, bool)
            order = np.argsort(-scores)
            tps = tps[order]
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            recall = tp_cum / num_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            # official normalization over recall/precision ≥ 0.1
            rec_interp = np.linspace(0, 1, 101)
            prec = np.interp(rec_interp, recall, precision, right=0) if len(recall) else np.zeros(101)
            # devkit calc_ap: drop recall ≤ min_recall (indices 0..10
            # inclusive — round(100·0.1)+1), floor precision at 0.1
            prec = prec[11:]
            prec = np.clip(prec - 0.1, 0, None)
            out[f"AP@{thr}"] = float(prec.mean() / 0.9)
            if thr == TP_THRESHOLD:
                enabled = dict(trans=True, scale=True, orient=self.use_orient,
                               vel=self.use_vel, attr=self.use_attr)
                for k, v in errs.items():
                    if enabled[k]:  # excluded metrics don't enter the mean
                        out[k.upper()] = float(np.mean(v)) if v else 1.0
        return out


@EVALUATORS.register()
class nuScenesDetEvaluator(DatasetEvaluator):
    def __init__(self, config, dataset):
        self.class_names = list(config.dataset.classes)
        self._acc = {c: self._make_acc(c) for c in self.class_names}

    @staticmethod
    def _make_acc(cname: str) -> _ClassAccumulator:
        n = cname.lower()
        is_barrier = "barrier" in n
        is_cone = "traffic_cone" in n or n == "cone"
        return _ClassAccumulator(
            yaw_period=np.pi if is_barrier else 2 * np.pi,
            use_orient=not is_cone,
            use_vel=not (is_barrier or is_cone),
            use_attr=not (is_barrier or is_cone),
        )

    def reset(self):
        self._acc = {c: self._make_acc(c) for c in self.class_names}

    def process(self, inputs, outputs):
        bsz = len(inputs["annotations"])
        for b in range(bsz):
            valid = np.asarray(outputs["valid"][b])
            boxes = np.asarray(outputs["box3d"][b])[valid]
            scores = np.asarray(outputs["scores"][b])[valid]
            labels = np.asarray(outputs["labels"][b])[valid]
            anno = inputs["annotations"][b] or {}
            gt_boxes = np.asarray(anno.get("gt_boxes", np.zeros((0, 9))))
            gt_labels = np.asarray(anno.get("labels", np.zeros(0, np.int64)))
            gt_attrs = np.asarray(anno.get("gt_attrs", np.full(len(gt_boxes), "")))
            # predicted attribute: velocity rule + class priors. 9-dim
            # boxes carry (vx, vy) at cols 6:8; 7-dim boxes have no
            # velocity head → speed 0 (prior fallback decides)
            has_vel = boxes.shape[-1] >= 9
            for ci, cname in enumerate(self.class_names):
                dm = labels == ci + 1
                gm = gt_labels == ci + 1
                db = boxes[dm]
                speeds = (np.linalg.norm(db[:, 6:8], axis=1)
                          if has_vel and len(db) else np.zeros(len(db)))
                det_attr = np.asarray(
                    [assign_attribute(cname, float(s)) for s in speeds]
                )
                self._acc[cname].frames.append(
                    dict(det=db, scores=scores[dm], gt=gt_boxes[gm],
                         det_attr=det_attr, gt_attr=gt_attrs[gm])
                )

    def evaluate(self):
        """The frames of every rank, gathered to the main process through
        `utils/distributed.py`, as WaymoDetEvaluator gathers its own."""
        shards = comm.all_gather({c: a.frames for c, a in self._acc.items()})
        if not comm.is_main_process():
            return {}
        merged = {c: self._make_acc(c) for c in self.class_names}
        for shard in shards:
            for c, frames in shard.items():
                merged[c].frames.extend(frames)

        results: Dict[str, float] = {}
        aps = []
        tp_errs = dict(TRANS=[], SCALE=[], ORIENT=[], VEL=[], ATTR=[])
        for c in self.class_names:
            r = merged[c].ap_and_tp()
            cls_aps = [r[f"AP@{t}"] for t in DIST_THRESHOLDS]
            results[f"nusc/{c}/AP"] = float(np.nanmean(cls_aps))
            aps.append(np.nanmean(cls_aps))
            for k in tp_errs:
                if k in r:
                    tp_errs[k].append(r[k])
        mAP = float(np.nanmean(aps))
        tp_terms = [
            1.0 - min(1.0, float(np.mean(v))) if v else 0.0 for v in tp_errs.values()
        ]
        results["nusc/mAP"] = mAP
        results["nusc/mATE"] = float(np.mean(tp_errs["TRANS"])) if tp_errs["TRANS"] else 1.0
        results["nusc/mASE"] = float(np.mean(tp_errs["SCALE"])) if tp_errs["SCALE"] else 1.0
        results["nusc/mAOE"] = float(np.mean(tp_errs["ORIENT"])) if tp_errs["ORIENT"] else 1.0
        results["nusc/mAVE"] = float(np.mean(tp_errs["VEL"])) if tp_errs["VEL"] else 1.0
        results["nusc/mAAE"] = float(np.mean(tp_errs["ATTR"])) if tp_errs["ATTR"] else 1.0
        results["nusc/NDS"] = (5 * mAP + sum(tp_terms)) / 10.0
        return results
