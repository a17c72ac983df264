"""Evaluator builder (port of `efg_tpu/evaluator/build.py`): every
evaluator efg_tpu registers is ported; a name efg_tpu does not know
raises the registry's KeyError, as in efg_tpu."""

from __future__ import annotations

from efg_tpu_torch.evaluator.registry import EVALUATORS


def build_evaluators(config, dataset):
    names = list(config.trainer.get("evaluators", []) or [])
    return [EVALUATORS.get(n)(config, dataset) for n in names]
