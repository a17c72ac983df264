"""Learning-rate and momentum schedules (port of the OneCycle,
WarmupMultiStep and LinearWarmupCosineAnnealing schedules and
`warmup_factor_at` of `efg_tpu/solver/schedulers.py`).

A schedule maps the update count (0 for the first update, as
`optax.inject_hyperparams` counts) to a value, computed in f32 as efg_tpu
computes it under jit.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

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


def warmup_factor_at(method: str, it: int, warmup_iters: int, warmup_factor: float) -> torch.Tensor:
    """The warm-up factor at iteration `it`, f32: `constant` (the factor),
    `linear` (factor → 1) or `burnin` ((it / iters)⁴); 1 from
    `warmup_iters` on."""
    it_f = torch.tensor(it, dtype=torch.float32)
    if method == "constant":
        f = torch.full_like(it_f, warmup_factor)
    elif method == "linear":
        alpha = it_f / warmup_iters
        f = warmup_factor * (1 - alpha) + alpha
    elif method == "burnin":
        x2 = (it_f / warmup_iters) ** 2
        f = x2 * x2  # jnp's x ** 4 (lax.integer_pow: squared twice)
    else:
        raise ValueError(f"Unknown warmup method: {method}")
    return torch.where(it_f >= warmup_iters, torch.ones_like(f), f)


def warmup_multi_step(
    *,
    lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 0.001,
    warmup_iters: int = 1000,
    warmup_method: str = "linear",
    **_,
) -> Tuple[Schedule, Optional[Schedule]]:
    """lr · warmup factor · gamma^(milestones passed); no momentum
    schedule."""
    milestones = list(milestones)
    if milestones != sorted(milestones):
        raise ValueError(f"milestones {milestones} are not sorted")
    ms = torch.tensor(milestones, dtype=torch.float32)

    def lr_fn(step: int) -> torch.Tensor:
        wf = warmup_factor_at(warmup_method, step, warmup_iters, warmup_factor)
        n_passed = (torch.tensor(float(step)) >= ms).sum().float()
        return lr * wf * torch.pow(torch.tensor(gamma, dtype=torch.float32), n_passed)

    return lr_fn, None


def linear_warmup_cosine(
    *,
    lr: float,
    max_iters: int,
    warmup_iters: int = 1000,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
    **_,
) -> Tuple[Schedule, Optional[Schedule]]:
    """A linear warm-up from `warmup_start_lr` to `lr` over `warmup_iters`,
    then a cosine from `lr` to `eta_min` at `max_iters`; no momentum
    schedule."""

    def lr_fn(step: int) -> torch.Tensor:
        s = torch.tensor(step, dtype=torch.float32)
        warm = warmup_start_lr + (lr - warmup_start_lr) * torch.clamp(
            s / max(warmup_iters, 1), 0, 1)
        pct = torch.clamp((s - warmup_iters) / max(max_iters - warmup_iters, 1), 0, 1)
        cos = eta_min + (lr - eta_min) * (1 + torch.cos(math.pi * pct)) / 2
        return torch.where(s < warmup_iters, warm, cos)

    return lr_fn, None


SCHEDULERS = {"OneCycle": one_cycle, "WarmupMultiStep": warmup_multi_step,
              "LinearWarmupCosineAnnealing": linear_warmup_cosine}


def build_scheduler(cfg) -> Tuple[Schedule, Optional[Schedule]]:
    """cfg = solver.lr_scheduler with the optimizer's `lr` merged in (the
    caller's job, as in efg_tpu): every schedule of efg_tpu's registry."""
    kwargs = {k: v for k, v in dict(cfg).items() if k != "type"}
    if cfg["type"] not in SCHEDULERS:
        raise KeyError(f"lr scheduler {cfg['type']!r} is not one of efg_tpu's "
                       f"{sorted(SCHEDULERS)}")
    return SCHEDULERS[cfg["type"]](**kwargs)
