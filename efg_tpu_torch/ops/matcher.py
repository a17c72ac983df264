"""Hungarian matching of fixed-shape cost matrices (port of
`efg_tpu/ops/matcher.py`).

The cost matrix has static shape [B, Q, G_max] with a validity mask over
the GT columns, and two exact solvers stand behind one signature, as in
efg_tpu:

- `host`: scipy's `linear_sum_assignment` on each sample's valid columns;
  the costs of a call are copied to the host together, the assignment
  copied back (a synchronisation per call);
- `device`: `device_match` (`ops/cuda/match_kernels.py`), efg_tpu's
  Jonker-Volgenant solver: on a CUDA tensor the kernel
  `csrc/device_match.cu`, one launch a call and no host copy; on a CPU
  tensor its plain PyTorch version, as efg_tpu runs its `lax` solver on
  the CPU when asked.

`auto` (the default) is efg_tpu's rule, applied by the tensor's device:
host for a CPU tensor, device for a CUDA tensor. The backend comes from
the `backend` argument, else from `set_matcher_backend`, else from
`EFG_MATCHER_BACKEND`, read at each call. Both solvers are exact: their
assignments agree up to ties. There is no fallback: a kernel that fails
to build or launch raises.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from efg_tpu_torch.ops.cuda.match_kernels import device_match

BACKENDS = ("host", "device", "auto")
_BACKEND: Optional[str] = None  # set_matcher_backend's choice, over the environment


def set_matcher_backend(backend: Optional[str]) -> None:
    """'host' | 'device' | 'auto', or None to read EFG_MATCHER_BACKEND again."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"matcher backend {backend!r}: expected one of {BACKENDS}")
    global _BACKEND
    _BACKEND = backend


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """The solver a call on `device` runs: 'host' or 'device'."""
    backend = backend or _BACKEND or os.environ.get("EFG_MATCHER_BACKEND", "auto")
    if backend not in BACKENDS:
        raise ValueError(f"matcher backend {backend!r} (EFG_MATCHER_BACKEND): expected one of "
                         f"{BACKENDS}")
    if backend == "auto":
        return "device" if device.type == "cuda" else "host"
    return backend


def solve_batch(cost: np.ndarray, gt_mask: np.ndarray) -> np.ndarray:
    """cost [B, Q, G], gt_mask [B, G] → assignment [B, G] int32 (query index
    per valid GT, −1 otherwise); nan and ±inf costs read as 0 and ±1e8."""
    from scipy.optimize import linear_sum_assignment

    cost = np.nan_to_num(np.asarray(cost, np.float64), posinf=1e8, neginf=-1e8)
    gt_mask = np.asarray(gt_mask)
    b, _, g = cost.shape
    out = np.full((b, g), -1, np.int32)
    for i in range(b):
        cols = np.flatnonzero(gt_mask[i])
        if cols.size == 0:
            continue
        row, col = linear_sum_assignment(cost[i][:, cols])
        out[i, cols[col]] = row.astype(np.int32)
    return out


def hungarian_match(cost: torch.Tensor, gt_mask: torch.Tensor,
                    backend: Optional[str] = None) -> torch.Tensor:
    """[B, Q, G] cost + [B, G] mask → [B, G] matched query index (−1 at
    padding), int64 on the cost's device. The assignment is a decision,
    not a function to differentiate: no gradient flows through it."""
    if resolve_backend(backend, cost.device) == "device":
        return device_match(cost.detach(), gt_mask.detach())
    assign = solve_batch(cost.detach().float().cpu().numpy(), gt_mask.detach().cpu().numpy())
    return torch.from_numpy(assign).to(device=cost.device, dtype=torch.int64)
