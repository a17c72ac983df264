"""Evaluator registry (port of `efg_tpu/evaluator/registry.py`)."""

from efg_tpu_torch.utils.registry import Registry

EVALUATORS = Registry("evaluators")
