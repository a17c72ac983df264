"""Learning-rate and momentum schedules (port of the OneCycle schedule of
`efg_tpu/solver/schedulers.py`).

A schedule maps the update count (0 for the first update, as
`optax.inject_hyperparams` counts) to a value, computed in f32 as efg_tpu
computes it under jit.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

Schedule = Callable[[int], torch.Tensor]


def _cos_anneal(start: float, end: float, pct: torch.Tensor) -> torch.Tensor:
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)


def one_cycle(
    *,
    lr: float,
    max_iters: int,
    pct_start: float = 0.4,
    div_factor: float = 10.0,
    final_div_factor: float = 1e4,
    base_momentum: float = 0.85,
    max_momentum: float = 0.95,
    **_,
) -> Tuple[Schedule, Schedule]:
    """torch `OneCycleLR`'s cosine strategy with momentum cycling: returns
    (lr_schedule, momentum_schedule), each step → f32 scalar tensor."""
    initial_lr = lr / div_factor
    min_lr = initial_lr / final_div_factor
    up = max(1, int(pct_start * max_iters) - 1)
    down = max(1, max_iters - up - 1)

    def phases(step: int):
        s = torch.tensor(step, dtype=torch.float32)
        return s <= up, torch.clamp(s / up, 0, 1), torch.clamp((s - up) / down, 0, 1)

    def lr_fn(step: int) -> torch.Tensor:
        rising, pct_up, pct_down = phases(step)
        return torch.where(rising, _cos_anneal(initial_lr, lr, pct_up),
                           _cos_anneal(lr, min_lr, pct_down))

    def mom_fn(step: int) -> torch.Tensor:
        rising, pct_up, pct_down = phases(step)
        return torch.where(rising, _cos_anneal(max_momentum, base_momentum, pct_up),
                           _cos_anneal(base_momentum, max_momentum, pct_down))

    return lr_fn, mom_fn


def build_scheduler(cfg) -> Tuple[Schedule, Schedule]:
    """cfg = solver.lr_scheduler with the optimizer's `lr` merged in (the
    caller's job, as in efg_tpu). Only OneCycle is ported so far."""
    kwargs = {k: v for k, v in dict(cfg).items() if k != "type"}
    if cfg["type"] != "OneCycle":
        raise KeyError(f"lr scheduler {cfg['type']!r} is not ported")
    return one_cycle(**kwargs)
