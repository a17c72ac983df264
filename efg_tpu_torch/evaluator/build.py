"""Evaluator builder (port of `efg_tpu/evaluator/build.py`).

efg_tpu registers five evaluators; the port registers those it has
ported. A config that names one of the others raises NotImplementedError
with its ROADMAP queue item; a name efg_tpu does not know either raises
the registry's KeyError, as in efg_tpu."""

from __future__ import annotations

from efg_tpu_torch.evaluator.registry import EVALUATORS

# evaluator name → ROADMAP queue 1 item that ports it
NOT_PORTED = {
    "COCOEvaluator": 10,
    "PanopticEvaluator": 11,
}


def evaluator_names(config):
    return list(config.trainer.get("evaluators", []) or [])


def check_ported(names):
    """Raise NotImplementedError on the first name the port has not ported."""
    for n in names:
        if n in NOT_PORTED:
            raise NotImplementedError(
                f"trainer.evaluators: {n} is not ported to efg_tpu_torch yet "
                f"(ROADMAP queue 1 item {NOT_PORTED[n]})")


def build_evaluators(config, dataset):
    names = evaluator_names(config)
    check_ported(names)
    return [EVALUATORS.get(n)(config, dataset) for n in names]
