"""AdamW with global-norm gradient clipping (port of `adamw` and
`build_optimizer` of `efg_tpu/solver/optimizers.py`).

efg_tpu's chain is `clip_by_global_norm(max_norm)` then `optax.adamw`
under `inject_hyperparams` (lr and β1 from schedules). Two of its rules
differ from torch's own AdamW and `clip_grad_norm_`, and are kept:
- every tensor is decayed, norm scales and biases included (efg_tpu's
  `adamw` passes no decay mask);
- the clip scales by max_norm / norm only when norm ≥ max_norm, with no
  epsilon.
`optax.flatten`, which efg_tpu wraps around the chain to fuse its TPU
launches, changes no number and has no counterpart.

The update runs in place on the parameter tensors, in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ ‖t‖²) over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """optax.adamw (eps_root 0, no decay mask) behind an optional
    clip_by_global_norm. `lr_schedule` / `momentum_schedule` map the update
    count to lr / β1; without a momentum schedule β1 = betas[0]."""

    def __init__(self, *, lr_schedule: Callable, momentum_schedule: Optional[Callable] = None,
                 weight_decay: float = 0.01, betas=(0.9, 0.99), eps: float = 1e-8,
                 max_norm: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.momentum_schedule = momentum_schedule
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.eps = eps
        self.max_norm = max_norm

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: AdamWState, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update of `params` in place; `grad_norm` is the grads' global
        norm when the caller has it already."""
        if self.max_norm is not None:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            # clip_by_global_norm: t if norm < max_norm else t / norm · max_norm
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, g / norm * self.max_norm) for g in grads]
        k = state.count
        # the hyperparameters are f32 values (as under jit), held as Python
        # floats so that no step copies a scalar to the card
        lr = float(self.lr_schedule(k))
        b1 = self.betas[0] if self.momentum_schedule is None else float(self.momentum_schedule(k))
        b2 = self.betas[1]
        count = k + 1
        c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** count) for b in (b1, b2))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2 + 0.0) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-lr * u)
        state.count = count


def build_optimizer(cfg, lr_schedule, momentum_schedule=None, *, grad_clip_cfg=None) -> AdamW:
    """cfg = solver.optimizer; grad_clip_cfg = solver.grad_clipper. Only
    AdamW with norm clipping is ported so far."""
    if cfg["type"] != "AdamW":
        raise KeyError(f"optimizer {cfg['type']!r} is not ported")
    max_norm = None
    if grad_clip_cfg and grad_clip_cfg.get("enabled", False):
        if grad_clip_cfg.get("clip_type", "norm") != "norm":
            raise KeyError(f"clip type {grad_clip_cfg['clip_type']!r} is not ported")
        max_norm = float(grad_clip_cfg.get("params", {}).get("max_norm", 10.0))
    kwargs = {k: v for k, v in dict(cfg).items() if k in ("weight_decay", "betas", "eps")}
    return AdamW(lr_schedule=lr_schedule, momentum_schedule=momentum_schedule,
                 max_norm=max_norm, **kwargs)
