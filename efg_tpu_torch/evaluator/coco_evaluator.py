"""COCO detection / instance-segmentation evaluator (port of
`efg_tpu/evaluator/coco_evaluator.py`), on the numpy COCO core
(`coco_eval_np.py`).

Predictions arrive as the 2D models' fixed-shape `predict` outputs, as
host numpy; boxes (predicted and GT) are divided by the resize scale that
`ResizeShortestEdge` recorded, back to the original image. When the model
emits instance masks and the pipeline rasterized GT masks, a segm pass
runs too. Every rank's frames are gathered and rank 0 evaluates; a
per-category AP table is logged.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from efg_tpu_torch.evaluator.coco_eval_np import COCOEvalNP
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator
from efg_tpu_torch.evaluator.registry import EVALUATORS
from efg_tpu_torch.utils import distributed as comm
from efg_tpu_torch.utils.logger import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def _resize_mask(mask: np.ndarray, hw) -> np.ndarray:
    """Nearest-neighbour resize of a mask to (h, w) (cv2.INTER_NEAREST)."""
    if mask.shape == tuple(hw):
        return mask
    import cv2

    return cv2.resize(mask.astype(np.uint8), (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)


@EVALUATORS.register()
class COCOEvaluator(DatasetEvaluator):
    def __init__(self, config, dataset):
        self.num_classes = len(getattr(dataset, "class_names", [])) or int(
            config.dataset.get("num_classes", 80))
        self.class_names = list(getattr(dataset, "class_names", []))
        self._frames: List[dict] = []

    def reset(self):
        self._frames = []

    def process(self, inputs, outputs):
        for b in range(len(inputs["annotations"])):
            valid = np.asarray(outputs["valid"][b])
            meta = inputs["metadata"][b] or {}
            scale = float(meta.get("scale", 1.0))
            anno = inputs["annotations"][b] or {}
            f = dict(
                det_boxes=np.asarray(outputs["boxes"][b])[valid] / scale
                if "boxes" in outputs else np.zeros((int(valid.sum()), 4), np.float32),
                det_scores=np.asarray(outputs["scores"][b])[valid],
                det_labels=np.asarray(outputs["labels"][b])[valid],
                gt_boxes=np.asarray(anno.get("boxes2d", np.zeros((0, 4)))) / scale,
                gt_classes=np.asarray(anno.get("classes", np.zeros(0, np.int64))),
                gt_iscrowd=np.asarray(anno.get("iscrowd", np.zeros(0, np.int64))) > 0,
                gt_areas=np.asarray(anno.get("areas", np.zeros(0))),
            )
            if "masks" in outputs and anno.get("masks_fixed") is not None:
                gm = np.asarray(anno["masks_fixed"]) > 0.5
                dm = np.asarray(outputs["masks"][b])[valid]
                hw = gm.shape[1:] if len(gm) else dm.shape[1:]
                f["det_masks"] = np.stack([_resize_mask(m, hw) for m in dm]) if len(dm) \
                    else np.zeros((0,) + tuple(hw), np.uint8)
                f["gt_masks"] = gm
                if "boxes" not in outputs:  # mask-derived boxes without a box head
                    boxes = np.zeros((len(dm), 4), np.float32)
                    for i, m in enumerate(f["det_masks"]):
                        ys, xs = np.nonzero(m)
                        if len(ys):
                            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                    f["det_boxes"] = boxes
            self._frames.append(f)

    def _run(self, frames, iou_type):
        ev = COCOEvalNP(iou_type=iou_type)
        for f in frames:
            for c in range(self.num_classes):
                dm = f["det_labels"] == c
                gm = f["gt_classes"] == c
                if not dm.any() and not gm.any():
                    continue
                kw = {}
                if iou_type == "segm":
                    kw = dict(det_masks=f["det_masks"][dm], gt_masks=f["gt_masks"][gm])
                ev.add_image(c, f["det_boxes"][dm], f["det_scores"][dm], f["gt_boxes"][gm],
                             f["gt_iscrowd"][gm], f["gt_areas"][gm], **kw)
        results = ev.summarize()
        rows = ev.per_category_ap()
        if rows:
            def name(c):
                return self.class_names[c] if c < len(self.class_names) else str(c)

            table = "  ".join(f"{name(c)}={ap:.3f}" for c, ap in rows.items())
            logger.info(f"per-category {iou_type} AP: {table}")
        return results

    def evaluate(self):
        shards = comm.all_gather(self._frames)
        if not comm.is_main_process():
            return {}
        frames = [f for s in shards for f in s]
        logger.info(f"COCO eval over {len(frames)} images")
        out = {f"coco/{k}": v for k, v in self._run(frames, "bbox").items()}
        if frames and "det_masks" in frames[0]:
            out.update({f"coco/segm_{k}": v for k, v in self._run(frames, "segm").items()})
        return out
