"""The optimizers of efg_tpu's `OPTIMIZERS` (port of
`efg_tpu/solver/optimizers.py`): AdamW, Adam, D2 SGD, AdamWMulti,
Adafactor and LARS_SGD, each behind the optional gradient clip of
`build_optimizer` (`clip_by_global_norm(max_norm)` or `clip(clip_value)`).

Each computes in torch what its optax chain computes, in f32, and keeps
the rules that differ from torch's own optimizers and clipping:
- AdamW decays every tensor, norm scales and biases included (efg_tpu's
  `adamw` passes no decay mask); Adam is optax.adam (no decay), and, as in
  efg_tpu, ignores a momentum schedule;
- D2 SGD adds the decayed weights to the gradient before the momentum
  trace, and decays a tensor unless its flax path has a name `bias`,
  `scale`, `mean` or `var`, or one containing `bn`, or it has ndim ≤ 1.
  The mask is read from efg_tpu's flax names (`utils/jax_import.py`
  `flax_names`), not from torch's: AutoAssign's `mu` / `sigma` [C, 2] are
  decayed, FCOS's `scales` [5] and every FrozenBN `weight` are not. Frozen
  stages are not exempt: under `freeze_at` their conv kernels get a zero
  gradient and still decay, as in efg_tpu;
- AdamWMulti is optax.adamw per label (eps 1e-9 by default), the lr of a
  leaf multiplied by the first `lr_multipliers` key that is a substring of
  its flax path joined by "/" (efg_tpu's `scale_for`). The port reads that
  path from `flax_names`, so each leaf gets efg_tpu's multiplier whatever
  torch names it: a torch name whose flax path differs (a BN's `weight` is
  flax's `scale`) is mapped through it;
- Adafactor is optax.adafactor(lr, weight_decay_rate=wd or None) with
  optax's defaults: decay rate 0.8 (β2 = 1 − (t+1)^−0.8), second moments
  factored over the two largest dims where the second largest is ≥ 128,
  the update clipped to block RMS 1, scaled by lr and by the parameter's
  RMS (at least 1e-3), ε 1e-30 added to the squared gradient, no momentum;
  the decayed weights are added after the lr scaling, as optax does. It
  decides and keeps each leaf's moments on the flax leaf's shape
  (`utils/jax_import.py` `flax_shapes`), not the torch tensor's: an MHA's
  flax kernels [C, NH, hd] are one Linear [C, C] in torch, which would
  factor where efg_tpu keeps a full moment;
- LARS_SGD is optax.lars: decayed weights added, the trust ratio
  tc·‖p‖/‖u‖ (1 where either norm is 0) on every leaf, −lr, then the
  momentum trace;
- the norm clip scales by max_norm / norm only when norm ≥ max_norm, with
  no epsilon; the value clip clamps every element to ±clip_value.
`optax.flatten`, which efg_tpu wraps around the AdamW and Adam chains to
fuse its TPU launches, changes no number and has no counterpart.

The updates run in place on the parameter tensors, in f32. Every state is
a dataclass with the update `count` and lists of per-parameter tensors,
which the trainer's checkpoints save by parameter name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

# efg_tpu's OPTIMIZERS registry: every name it builds
OPTIMIZERS = ("AdamW", "Adam", "SGD", "D2_SGD", "AdamWMulti", "Adafactor", "LARS_SGD")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ ‖t‖²) over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: t if norm < max_norm else t / norm · max_norm."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class _Clipped:
    """The gradient clip build_optimizer puts ahead of an optimizer: by
    global norm (`max_norm`) or by value (`clip_value`), or none."""

    max_norm: Optional[float] = None
    clip_value: Optional[float] = None

    def clip(self, grads: Sequence[torch.Tensor],
             grad_norm: Optional[torch.Tensor]) -> Sequence[torch.Tensor]:
        if self.max_norm is not None:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            grads = clip_by_global_norm(grads, norm, self.max_norm)
        if self.clip_value is not None:  # optax.clip
            grads = [torch.clamp(g, -self.clip_value, self.clip_value) for g in grads]
        return grads


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW(_Clipped):
    """optax.adamw (eps_root 0, no decay mask), or optax.adam with
    `weight_decay=None`. `lr_schedule` / `momentum_schedule` map the update
    count to lr / β1; without a momentum schedule β1 = betas[0].
    `lr_mults`, one a parameter, multiply the lr (AdamWMulti)."""

    def __init__(self, *, lr_schedule: Callable, momentum_schedule: Optional[Callable] = None,
                 weight_decay: Optional[float] = 0.01, betas=(0.9, 0.99), eps: float = 1e-8,
                 lr_mults: Optional[Sequence[float]] = None, max_norm: Optional[float] = None,
                 clip_value: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.momentum_schedule = momentum_schedule
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.eps = eps
        self.lr_mults = None if lr_mults is None else list(lr_mults)
        self.max_norm = max_norm
        self.clip_value = clip_value

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        if self.lr_mults is not None and len(self.lr_mults) != len(params):
            raise ValueError(f"{len(params)} parameters, {len(self.lr_mults)} lr multipliers")
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: AdamWState, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update of `params` in place; `grad_norm` is the grads' global
        norm when the caller has it already."""
        grads = self.clip(grads, grad_norm)
        k = state.count
        # the hyperparameters are f32 values (as under jit), held as Python
        # floats so that no step copies a scalar to the card
        lr = _f32(self.lr_schedule(k))
        lrs = [float(lr)] * len(params) if self.lr_mults is None \
            else [float(lr * m) for m in self.lr_mults]  # efg_tpu's lr_schedule(step) * mult
        b1 = self.betas[0] if self.momentum_schedule is None else float(self.momentum_schedule(k))
        b2 = self.betas[1]
        count = k + 1
        c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** count) for b in (b1, b2))
        for p, g, mu, nu, lr_p in zip(params, grads, state.mu, state.nu, lrs):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2 + 0.0) + self.eps)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p
            p.add_(-lr_p * u)
        state.count = count


DECAY_EXEMPT = ("bias", "scale", "mean", "var")


def _flax_paths(module: nn.Module) -> List[tuple]:
    """The flax path of every parameter of `module`, in `parameters()` order."""
    from efg_tpu_torch.utils.jax_import import flax_names

    names = flax_names(module)
    paths = []
    for key, _ in module.named_parameters():
        if key not in names:
            raise KeyError(f"parameter {key} has no flax name: its rule cannot be read")
        paths.append(names[key][1])
    return paths


def leaf_layouts(module: nn.Module) -> list:
    """The flax layout (`utils/jax_import.py` `FlaxLayout`) of every
    parameter of `module`, in `parameters()` order."""
    from efg_tpu_torch.utils.jax_import import flax_shapes

    shapes = flax_shapes(module)
    out = []
    for key, _ in module.named_parameters():
        if key not in shapes:
            raise KeyError(f"parameter {key} has no flax leaf: its layout cannot be read")
        out.append(shapes[key])
    return out


def decay_mask(module: nn.Module) -> List[bool]:
    """efg_tpu's `_norm_bias_mask` for `module.parameters()`, in order:
    True = decayed. Decided on each parameter's flax path and leaf rank."""
    return [not any(n in DECAY_EXEMPT or "bn" in n.lower() for n in path) and p.ndim > 1
            for path, p in zip(_flax_paths(module), module.parameters())]


def lr_multipliers(module: nn.Module, mults: Optional[Dict[str, float]]) -> List[float]:
    """efg_tpu's AdamWMulti `scale_for` for `module.parameters()`, in order:
    the factor of the first key of `mults` that is a substring of the
    parameter's flax path joined by "/", else 1."""
    mults = {str(k): float(v) for k, v in dict(mults or {}).items()}
    out = []
    for path in _flax_paths(module):
        joined = "/".join(path)
        out.append(next((m for key, m in mults.items() if key in joined), 1.0))
    return out


@dataclasses.dataclass
class SGDState:
    count: int  # updates applied so far
    trace: List[torch.Tensor]  # the momentum trace


class SGD(_Clipped):
    """efg_tpu's `D2_SGD` (also registered as `SGD`): masked
    add_decayed_weights, then optax.sgd (trace with decay `momentum`,
    nesterov optional, then −lr from the schedule). `decay` holds
    `decay_mask`'s flags in `parameters()` order."""

    def __init__(self, *, lr_schedule: Callable, decay: Sequence[bool], momentum: float = 0.9,
                 weight_decay: float = 1e-4, nesterov: bool = False,
                 max_norm: Optional[float] = None, clip_value: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.decay = list(decay)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.max_norm = max_norm
        self.clip_value = clip_value

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        if len(params) != len(self.decay):
            raise ValueError(f"{len(params)} parameters, decay mask of {len(self.decay)}")
        return SGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: SGDState, grad_norm: Optional[torch.Tensor] = None) -> None:
        grads = self.clip(grads, grad_norm)
        lr = float(self.lr_schedule(state.count))
        m = self.momentum
        for p, g, tr, decayed in zip(params, grads, state.trace, self.decay):
            if decayed:
                g = g + self.weight_decay * p
            tr.copy_(g + m * tr)
            u = g + m * tr if self.nesterov else tr
            p.add_(u * -lr)
        state.count += 1


class LARS(_Clipped):
    """efg_tpu's `LARS_SGD`, optax.lars: u = g + wd·p on every leaf, times
    the trust ratio tc·‖p‖ / ‖u‖ (1 where either norm is 0), times −lr,
    then the momentum trace t = u + momentum·t is the update."""

    def __init__(self, *, lr_schedule: Callable, momentum: float = 0.9,
                 weight_decay: float = 1e-4, trust_coefficient: float = 0.001,
                 max_norm: Optional[float] = None, clip_value: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust_coefficient = trust_coefficient
        self.max_norm = max_norm
        self.clip_value = clip_value

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        return SGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: SGDState, grad_norm: Optional[torch.Tensor] = None) -> None:
        grads = self.clip(grads, grad_norm)
        lr = float(self.lr_schedule(state.count))
        for p, g, tr in zip(params, grads, state.trace):
            u = g + self.weight_decay * p
            p_norm, u_norm = torch.sqrt(torch.sum(p * p)), torch.sqrt(torch.sum(u * u))
            ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0), torch.ones_like(p_norm),
                                self.trust_coefficient * p_norm / (u_norm + 0.0))
            tr.copy_((-lr) * (u * ratio) + self.momentum * tr)
            p.add_(tr)
        state.count += 1


@dataclasses.dataclass
class AdafactorState:
    """The moments in each leaf's flax layout, as optax keeps them."""

    count: int  # updates applied so far
    v_row: List[torch.Tensor]  # factored leaves: the row statistics ([1] elsewhere)
    v_col: List[torch.Tensor]  # factored leaves: the column statistics ([1] elsewhere)
    v: List[torch.Tensor]  # the other leaves: the second moment ([1] on factored ones)


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128):
    """optax's `_factored_dims`: (d1, d0), the second largest and the
    largest dim (numpy's argsort order), or None below ndim 2 or where the
    second largest is under `min_dim_size_to_factor`."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Clipped):
    """efg_tpu's `Adafactor`, optax.adafactor(lr, weight_decay_rate=wd or
    None) with optax's defaults (see the module docstring). `layouts`, one
    a parameter in `parameters()` order, give each leaf's flax layout: the
    gradient is viewed in it, the moments are decided and kept in it, and
    the update is mapped back."""

    decay_rate, min_dim_size_to_factor, eps = 0.8, 128, 1e-30
    clipping_threshold, min_scale = 1.0, 1e-3

    def __init__(self, *, lr_schedule: Callable, layouts: Sequence, weight_decay: float = 0.0,
                 max_norm: Optional[float] = None, clip_value: Optional[float] = None):
        self.lr_schedule = lr_schedule
        self.layouts = list(layouts)
        self.weight_decay = weight_decay or None
        self.max_norm = max_norm
        self.clip_value = clip_value

    def init(self, params: Sequence[torch.Tensor]) -> AdafactorState:
        if len(params) != len(self.layouts):
            raise ValueError(f"{len(params)} parameters, {len(self.layouts)} leaf layouts")
        state = AdafactorState(0, [], [], [])
        for p, layout in zip(params, self.layouts):
            if tuple(p.shape) != layout.torch_shape:
                raise ValueError(f"parameter {tuple(p.shape)}, layout of {layout.torch_shape}")
            one = p.new_zeros(1)
            shape = layout.shape
            dims = factored_dims(shape, self.min_dim_size_to_factor)
            if dims is None:
                state.v_row.append(one)
                state.v_col.append(one.clone())
                state.v.append(p.new_zeros(shape))
            else:
                d1, d0 = dims
                state.v_row.append(p.new_zeros([n for i, n in enumerate(shape) if i != d0]))
                state.v_col.append(p.new_zeros([n for i, n in enumerate(shape) if i != d1]))
                state.v.append(one)
        return state

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: AdafactorState, grad_norm: Optional[torch.Tensor] = None) -> None:
        grads = self.clip(grads, grad_norm)
        k = state.count
        rho = 1.0 - _f32(k + 1) ** (-self.decay_rate)  # β2 of this step, in f32
        decay, keep = float(rho), float(1.0 - rho)
        lr = float(_f32(self.lr_schedule(k)))
        for i, (p, g, layout) in enumerate(zip(params, grads, self.layouts)):
            g = layout.to_flax(g)
            g2 = g * g + self.eps
            dims = factored_dims(layout.shape, self.min_dim_size_to_factor)
            if dims is None:
                state.v[i].copy_(decay * state.v[i] + keep * g2)
                u = g * state.v[i] ** -0.5
            else:
                d1, d0 = dims
                v_row, v_col = state.v_row[i], state.v_col[i]
                v_row.copy_(decay * v_row + keep * torch.mean(g2, dim=d0))
                v_col.copy_(decay * v_col + keep * torch.mean(g2, dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = torch.mean(v_row, dim=reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            u = layout.from_flax(u)
            # clip_by_block_rms, scale_by_learning_rate, scale_by_param_block_rms
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.clipping_threshold, min=1.0)
            u = lr * u
            p_rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(p_rms <= self.min_scale, torch.full_like(p_rms, self.min_scale),
                                p_rms)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p
            p.sub_(u)
        state.count = k + 1


def _clip_args(grad_clip_cfg) -> Dict[str, float]:
    """build_optimizer's clip: {} or {"max_norm": …} or {"clip_value": …}."""
    if not (grad_clip_cfg and grad_clip_cfg.get("enabled", False)):
        return {}
    clip_type = grad_clip_cfg.get("clip_type", "norm")
    params = grad_clip_cfg.get("params", {})
    if clip_type == "norm":
        return {"max_norm": float(params.get("max_norm", 10.0))}
    if clip_type == "value":
        return {"clip_value": float(params.get("clip_value", 1.0))}
    raise ValueError(f"Unknown clip_type {clip_type}")


def build_optimizer(cfg, lr_schedule, momentum_schedule=None, *, grad_clip_cfg=None,
                    module: Optional[nn.Module] = None):
    """cfg = solver.optimizer; grad_clip_cfg = solver.grad_clipper. Every
    optimizer of efg_tpu's registry, with optional norm or value clipping.
    SGD / D2_SGD (decay mask) and AdamWMulti (lr multipliers) read the
    `module`'s flax paths, Adafactor its flax leaf shapes."""
    kind = cfg["type"]
    if kind not in OPTIMIZERS:
        raise KeyError(f"optimizer {kind!r} is not one of efg_tpu's {OPTIMIZERS}")
    kw = {k: v for k, v in dict(cfg).items() if k not in ("type", "lr")}
    clip = _clip_args(grad_clip_cfg)

    def pick(*names):
        return {k: kw[k] for k in names if k in kw}

    if kind == "AdamW":
        return AdamW(lr_schedule=lr_schedule, momentum_schedule=momentum_schedule,
                     **pick("weight_decay", "betas", "eps"), **clip)
    if kind == "Adam":  # optax.adam: no decay, β1 fixed
        return AdamW(lr_schedule=lr_schedule, weight_decay=None,
                     **{"betas": (0.9, 0.999), **pick("betas", "eps")}, **clip)
    if kind == "LARS_SGD":
        return LARS(lr_schedule=lr_schedule,
                    **pick("momentum", "weight_decay", "trust_coefficient"), **clip)
    if module is None:
        raise ValueError(f"optimizer {kind!r} needs the module for its per-parameter rule")
    if kind == "Adafactor":
        return Adafactor(lr_schedule=lr_schedule, layouts=leaf_layouts(module),
                         **pick("weight_decay"), **clip)
    if kind == "AdamWMulti":
        return AdamW(lr_schedule=lr_schedule, lr_mults=lr_multipliers(module, kw.get(
            "lr_multipliers")), **{"eps": 1e-9, **pick("weight_decay", "betas", "eps")}, **clip)
    return SGD(lr_schedule=lr_schedule, decay=decay_mask(module),
               **pick("momentum", "weight_decay", "nesterov"), **clip)
