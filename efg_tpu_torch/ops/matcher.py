"""Hungarian matching of fixed-shape cost matrices (port of
`efg_tpu/ops/matcher.py`).

The cost matrix has static shape [B, Q, G_max] with a validity mask over
the GT columns; each sample's valid columns are solved exactly by scipy's
`linear_sum_assignment` (shortest augmenting path, Jonker-Volgenant) on
the host. efg_tpu picks that solver on the CPU and its `device_match`, the
same algorithm in `lax` control flow, on an accelerator. The port solves on
the host on both devices: the cost matrices of a step are copied to the
host once, all problems together, and the assignment copied back. Both
solvers are exact, so the assignments agree up to ties.
`EFG_MATCHER_BACKEND=device` asks for the device solver, which is not
ported (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEVICE_MATCH_ITEM = 13  # ROADMAP queue 1: device_match


def _backend() -> str:
    backend = os.environ.get("EFG_MATCHER_BACKEND", "auto")
    if backend not in ("host", "device", "auto"):
        raise ValueError(f"EFG_MATCHER_BACKEND={backend!r}: expected 'host', 'device' or 'auto'")
    if backend == "device":
        raise NotImplementedError(
            "EFG_MATCHER_BACKEND=device (efg_tpu's device_match) is not ported to efg_tpu_torch "
            f"yet (ROADMAP queue 1 item {DEVICE_MATCH_ITEM}); the port solves on the host")
    return "host"


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


def hungarian_match(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """[B, Q, G] cost + [B, G] mask → [B, G] matched query index (−1 at
    padding), int64 on the cost's device. The assignment is a decision,
    not a function to differentiate: no gradient flows through it."""
    _backend()
    assign = solve_batch(cost.detach().float().cpu().numpy(), gt_mask.detach().cpu().numpy())
    return torch.from_numpy(assign).to(device=cost.device, dtype=torch.int64)
