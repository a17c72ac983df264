"""Evaluator base classes (port of `efg_tpu/evaluator/evaluator.py`).

An evaluator is host code: `process` takes the host batch and the eval
step's outputs as numpy arrays, `evaluate` returns a flat result dict."""

from __future__ import annotations

from typing import Dict, List, Optional


class DatasetEvaluator:
    def reset(self):
        pass

    def process(self, inputs, outputs):
        pass

    def evaluate(self) -> Optional[Dict]:
        pass


class DatasetEvaluators(DatasetEvaluator):
    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def evaluate(self):
        results = {}
        for e in self._evaluators:
            r = e.evaluate()
            if r:
                for k, v in r.items():
                    assert k not in results, f"Duplicate eval key {k}"
                    results[k] = v
        return results
