"""Evaluators (port of `efg_tpu/evaluator`): the base classes, the
builder, and the evaluators ported so far. Importing the package
registers them."""

from efg_tpu_torch.evaluator.build import build_evaluators
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator, DatasetEvaluators
from efg_tpu_torch.evaluator.registry import EVALUATORS

# trigger registrations
from efg_tpu_torch.evaluator import waymo_evaluator as _waymo  # noqa: F401
from efg_tpu_torch.evaluator import nuscenes_evaluator as _nuscenes  # noqa: F401
from efg_tpu_torch.evaluator import tracking_evaluator as _tracking  # noqa: F401

__all__ = ["EVALUATORS", "build_evaluators", "DatasetEvaluator", "DatasetEvaluators"]
