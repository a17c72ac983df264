"""Evaluators (port of `efg_tpu/evaluator`): the base classes, the
builder, and every evaluator efg_tpu registers. Importing the package
registers them."""

from efg_tpu_torch.evaluator.build import build_evaluators
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator, DatasetEvaluators
from efg_tpu_torch.evaluator.registry import EVALUATORS

# trigger registrations
from efg_tpu_torch.evaluator import waymo_evaluator as _waymo  # noqa: F401
from efg_tpu_torch.evaluator import nuscenes_evaluator as _nuscenes  # noqa: F401
from efg_tpu_torch.evaluator import tracking_evaluator as _tracking  # noqa: F401
from efg_tpu_torch.evaluator import coco_evaluator as _coco  # noqa: F401
from efg_tpu_torch.evaluator import panoptic_evaluator as _panoptic  # noqa: F401

__all__ = ["EVALUATORS", "build_evaluators", "DatasetEvaluator", "DatasetEvaluators"]
