"""AdamW and D2 SGD with global-norm gradient clipping (port of `adamw`,
`d2_sgd`, `_norm_bias_mask` and `build_optimizer` of
`efg_tpu/solver/optimizers.py`).

efg_tpu's chains are `clip_by_global_norm(max_norm)` (when enabled) then
`optax.adamw` under `inject_hyperparams` (lr and β1 from schedules), or
then `masked(add_decayed_weights)` and `optax.sgd` (D2 SGD). Their rules
that differ from torch's own optimizers and `clip_grad_norm_` are kept:
- AdamW decays every tensor, norm scales and biases included (efg_tpu's
  `adamw` passes no decay mask);
- D2 SGD adds the decayed weights to the gradient before the momentum
  trace, and decays a tensor unless its flax path has a name `bias`,
  `scale`, `mean` or `var`, or one containing `bn`, or it has ndim ≤ 1.
  The mask is read from efg_tpu's flax names (`utils/jax_import.py`
  `flax_names`), not from torch's: AutoAssign's `mu` / `sigma` [C, 2] are
  decayed, FCOS's `scales` [5] and every FrozenBN `weight` are not. Frozen
  stages are not exempt: under `freeze_at` their conv kernels get a zero
  gradient and still decay, as in efg_tpu;
- the clip scales by max_norm / norm only when norm ≥ max_norm, with no
  epsilon.
`optax.flatten`, which efg_tpu wraps around the AdamW chain to fuse its
TPU launches, changes no number and has no counterpart.

The updates run in place on the parameter tensors, in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ ‖t‖²) over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: t if norm < max_norm else t / norm · max_norm."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


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
            grads = clip_by_global_norm(grads, norm, self.max_norm)
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


DECAY_EXEMPT = ("bias", "scale", "mean", "var")


def decay_mask(module: nn.Module) -> List[bool]:
    """efg_tpu's `_norm_bias_mask` for `module.parameters()`, in order:
    True = decayed. Decided on each parameter's flax path and leaf rank."""
    from efg_tpu_torch.utils.jax_import import flax_names

    names = flax_names(module)
    mask = []
    for key, p in module.named_parameters():
        if key not in names:
            raise KeyError(f"parameter {key} has no flax name: the decay mask cannot be read")
        _, path = names[key]
        exempt = any(n in DECAY_EXEMPT or "bn" in n.lower() for n in path)
        mask.append(not exempt and p.ndim > 1)
    return mask


@dataclasses.dataclass
class SGDState:
    count: int  # updates applied so far
    trace: List[torch.Tensor]  # the momentum trace


class SGD:
    """efg_tpu's `D2_SGD` (also registered as `SGD`): masked
    add_decayed_weights, then optax.sgd (trace with decay `momentum`,
    nesterov optional, then −lr from the schedule), behind an optional
    clip_by_global_norm. `decay` holds `decay_mask`'s flags in
    `parameters()` order."""

    def __init__(self, *, lr_schedule: Callable, decay: Sequence[bool], momentum: float = 0.9,
                 weight_decay: float = 1e-4, nesterov: bool = False,
                 max_norm: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.decay = list(decay)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.max_norm = max_norm

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        if len(params) != len(self.decay):
            raise ValueError(f"{len(params)} parameters, decay mask of {len(self.decay)}")
        return SGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: SGDState, grad_norm: Optional[torch.Tensor] = None) -> None:
        if self.max_norm is not None:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            grads = clip_by_global_norm(grads, norm, self.max_norm)
        lr = float(self.lr_schedule(state.count))
        m = self.momentum
        for p, g, tr, decayed in zip(params, grads, state.trace, self.decay):
            if decayed:
                g = g + self.weight_decay * p
            tr.copy_(g + m * tr)
            u = g + m * tr if self.nesterov else tr
            p.add_(u * -lr)
        state.count += 1


# optimizers efg_tpu has that the port has not (ROADMAP queue 1 item 13)
NOT_PORTED = ("Adam", "AdamWMulti", "Adafactor", "LARS_SGD")


def build_optimizer(cfg, lr_schedule, momentum_schedule=None, *, grad_clip_cfg=None,
                    module: Optional[nn.Module] = None):
    """cfg = solver.optimizer; grad_clip_cfg = solver.grad_clipper. AdamW,
    and SGD / D2_SGD (which need the `module` for their decay mask), with
    optional norm clipping."""
    kind = cfg["type"]
    if kind in NOT_PORTED:
        raise KeyError(f"optimizer {kind!r} is not ported to efg_tpu_torch yet "
                       "(ROADMAP queue 1 item 13)")
    if kind not in ("AdamW", "SGD", "D2_SGD"):
        raise KeyError(f"optimizer {kind!r} is not ported")
    max_norm = None
    if grad_clip_cfg and grad_clip_cfg.get("enabled", False):
        if grad_clip_cfg.get("clip_type", "norm") != "norm":
            raise KeyError(f"clip type {grad_clip_cfg['clip_type']!r} is not ported")
        max_norm = float(grad_clip_cfg.get("params", {}).get("max_norm", 10.0))
    if kind == "AdamW":
        kwargs = {k: v for k, v in dict(cfg).items() if k in ("weight_decay", "betas", "eps")}
        return AdamW(lr_schedule=lr_schedule, momentum_schedule=momentum_schedule,
                     max_norm=max_norm, **kwargs)
    if module is None:
        raise ValueError(f"optimizer {kind!r} needs the module for its weight-decay mask")
    kwargs = {k: v for k, v in dict(cfg).items() if k in ("momentum", "weight_decay", "nesterov")}
    return SGD(lr_schedule=lr_schedule, decay=decay_mask(module), max_norm=max_norm, **kwargs)
