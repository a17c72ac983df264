"""Waymo-protocol detection evaluator (port of
`efg_tpu/evaluator/waymo_evaluator.py`): gathers per-frame predictions,
then computes AP/APH at L1/L2 in-process with the official-protocol core
(`waymo_official.py`) or the greedy one (`det3d_metrics.py`). IoU
thresholds follow the official config: 0.7 vehicle / 0.5 pedestrian /
0.5 cyclist.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from efg_tpu_torch.evaluator.det3d_metrics import DetectionAPCalculator
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator
from efg_tpu_torch.evaluator.registry import EVALUATORS
from efg_tpu_torch.evaluator.waymo_official import WaymoOfficialCalculator
from efg_tpu_torch.utils import distributed as comm
from efg_tpu_torch.utils.logger import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)

WAYMO_IOU = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}


def _yaw_last(boxes: np.ndarray) -> np.ndarray:
    """[N, 9] (x, y, z, dx, dy, dz, vx, vy, yaw) → [N, 7] without the
    velocity; 7-column boxes pass as they are."""
    if boxes.shape[-1] > 7:
        return boxes[:, [0, 1, 2, 3, 4, 5, boxes.shape[-1] - 1]]
    return boxes


@EVALUATORS.register()
class WaymoDetEvaluator(DatasetEvaluator):
    """`trainer.waymo_metric: official` (default: Hungarian matching and
    101-cutoff recall-sampled AP, `waymo_official.py`) or `greedy` (the
    fast path, `det3d_metrics.py`)."""

    def __init__(self, config, dataset):
        self.class_names = list(config.dataset.classes)
        thr = {c: WAYMO_IOU.get(c, 0.5) for c in self.class_names}
        core = config.trainer.get("waymo_metric", "official")
        if core == "official":
            self.calc = WaymoOfficialCalculator(self.class_names, thr)
        elif core == "greedy":
            self.calc = DetectionAPCalculator(self.class_names, thr)
        else:
            raise ValueError(f"trainer.waymo_metric={core!r}: expected official or greedy")
        self._frames: List[Dict] = []

    def reset(self):
        self._frames = []
        self.calc.reset()

    def process(self, inputs, outputs):
        """inputs: host batch (with its `annotations` list); outputs: the
        eval step's fixed-shape detections as numpy (box3d / scores /
        labels / valid, [B, K])."""
        bsz = len(inputs["annotations"])
        for b in range(bsz):
            valid = np.asarray(outputs["valid"][b])
            anno = inputs["annotations"][b] or {}
            self._frames.append(
                dict(
                    pred_boxes=np.asarray(outputs["box3d"][b])[valid],
                    pred_scores=np.asarray(outputs["scores"][b])[valid],
                    pred_labels=np.asarray(outputs["labels"][b])[valid],
                    gt_boxes=np.asarray(anno.get("gt_boxes", np.zeros((0, 9)))),
                    gt_labels=np.asarray(anno.get("labels", np.zeros((0,), np.int64))),
                    gt_difficulty=np.asarray(anno.get("difficulty", np.zeros((0,), np.int64))),
                    gt_num_points=np.asarray(
                        anno.get("num_points_in_gt", np.full((len(anno.get("gt_boxes", []))), 100))
                    ),
                )
            )

    def evaluate(self):
        all_frames = comm.all_gather(self._frames)
        if not comm.is_main_process():
            return {}
        frames = [f for shard in all_frames for f in shard]
        logger.info(f"Waymo eval over {len(frames)} frames")
        for f in frames:
            self.calc.add_frame(
                _yaw_last(f["pred_boxes"]), f["pred_scores"], f["pred_labels"],
                _yaw_last(f["gt_boxes"]), f["gt_labels"], f["gt_difficulty"], f["gt_num_points"],
            )
        results = self.calc.compute()
        maph_l2 = np.nanmean([results[f"{c}/L2/APH"] for c in self.class_names])
        results["mAPH/L2"] = float(maph_l2)
        return {f"waymo/{k}": v for k, v in results.items()}
