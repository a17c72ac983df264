"""The exact assignment solver on the card (port of efg_tpu's
`device_match`, `efg_tpu/ops/matcher.py:55-152`).

`device_match(cost, gt_mask)` solves a batch of [Q, G] cost matrices with
the Jonker-Volgenant shortest augmenting path, one Dijkstra search per
valid GT row, exactly as efg_tpu's `lax` version does: a CUDA tensor
launches `csrc/device_match.cu` (one block per problem, one launch a call,
no host copy) or raises; a CPU tensor runs `device_match_plain`, the same
algorithm in PyTorch, step for step, on the CPU. Both are f32 additions and
subtractions in efg_tpu's order with jnp.argmin's tie rule, so the kernel,
the plain version and efg_tpu give the same assignment bit for bit.
`launches["device_match"]` counts the kernel's launches (CPU calls never
count).

The kernel's plan (`plan`) is computed here from the source's `constexpr`
lines, as the kernel computes it: where the staged costs and the state fit
the block's shared memory the call allocates no workspace and makes one C
call; otherwise it allocates the workspace the plan names first.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, List, Optional

import torch

from efg_tpu_torch.ops.cuda import build as _build

launches: Dict[str, int] = {"device_match": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "device_match": {
        "efg_device_match_plan": [_I, _I, _I, *[ctypes.POINTER(_I)] * 3, ctypes.POINTER(_LL),
                                  *[ctypes.POINTER(_I)] * 2, ctypes.POINTER(_LL)],
        "efg_device_match": [_I, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
        "efg_argmin_chain": [_I, _I, _I, _P, _P],
    },
}
KERNEL_SOURCES = tuple(_SIGNATURES)

POSINF, NEGINF = 1e8, -1e8  # efg_tpu's nan_to_num of the costs (nan → 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _solve_one(c: torch.Tensor, valid: torch.Tensor, steps: List[int],
               rows: Optional[List[int]] = None) -> torch.Tensor:
    """One problem: c [Q, G] f32, valid [G] bool → col4row [G] int64; the
    Dijkstra steps of each row solved are appended to `steps`, and the
    row each step reads to `rows` when given."""
    q, g = c.shape
    cst = torch.nan_to_num(c.t(), nan=0.0, posinf=POSINF, neginf=NEGINF).contiguous()  # [G, Q]
    inf = torch.tensor(float("inf"))
    u, v = torch.zeros(g), torch.zeros(q)
    row4col = torch.full((q,), -1, dtype=torch.int64)
    col4row = torch.full((g,), -1, dtype=torch.int64)
    valid_rows = valid.tolist()
    for cur in range(g):
        if not (valid_rows[cur] and bool((row4col < 0).any())):
            continue
        sink, i, min_val, n = -1, cur, torch.tensor(0.0), 0
        remaining = torch.ones(q, dtype=torch.bool)
        spc = torch.full((q,), float("inf"))
        path = torch.zeros(q, dtype=torch.int64)
        in_tree = torch.zeros(g, dtype=torch.bool)
        while sink < 0 and bool(remaining.any()) and n <= g:
            if rows is not None:
                rows.append(i)
            in_tree[i] = True
            r = min_val + cst[i] - u[i] - v
            upd = remaining & (r < spc)
            path = torch.where(upd, i, path)
            spc = torch.where(upd, r, spc)
            masked = torch.where(remaining, spc, inf)
            j = int(torch.argmin(masked))  # the first index of the minimum
            min_val = masked[j]
            remaining[j] = False
            owner = int(row4col[j])
            if owner < 0:
                sink = j
            else:
                i = owner
            n += 1
        steps.append(n)
        # dual update (Crouse's formulation, as scipy's)
        u[cur] += min_val
        others = in_tree.clone()
        others[cur] = False
        spc_at = spc[torch.clamp(col4row, 0, q - 1)]
        u = torch.where(others, u + (min_val - spc_at), u)
        v = torch.where(~remaining, v - (min_val - spc), v)
        # augment: walk the predecessors from the sink back to cur
        j, done, n = sink, sink < 0, 0
        while not done and n <= g:
            i = int(path[j])
            row4col[j] = i
            j_next = int(col4row[i])
            col4row[i] = j
            done, j, n = i == cur, j_next, n + 1
    return torch.where(valid, col4row, torch.full_like(col4row, -1))


def device_match_plain(cost: torch.Tensor, gt_mask: torch.Tensor,
                       steps: Optional[List[List[int]]] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, Q, G] cost, [B, G] mask →
    [B, G] int64 on the cost's device (query per valid GT, −1 otherwise).
    It runs on the CPU, a CUDA input copied there first (its arithmetic,
    f32 additions and subtractions, rounds the same on either processor).
    `steps`, when given, receives one list per problem: the Dijkstra steps
    of every row solved, in order (the kernel's serial chain)."""
    b, q, g = cost.shape
    c = cost.detach().float().cpu()
    m = gt_mask.detach().bool().cpu()
    if q == 0:
        return torch.full((b, g), -1, dtype=torch.int64, device=cost.device)
    out = []
    for k in range(b):
        rows: List[int] = []
        out.append(_solve_one(c[k], m[k], rows))
        if steps is not None:
            steps.append(rows)
    if not out:
        return torch.empty((0, g), dtype=torch.int64, device=cost.device)
    return torch.stack(out).to(cost.device)


@functools.lru_cache(maxsize=None)
def source_constants(path: Optional[str] = None) -> Dict[str, int]:
    """The integer `constexpr` constants of csrc/device_match.cu (or of the
    source at `path`) that are arithmetic, each evaluated from the earlier
    ones (a conditional one is C's alone)."""
    text = open(path or _build.CSRC / "device_match.cu").read()
    env: Dict[str, int] = {}
    for name, expr in re.findall(r"constexpr (?:int|long long) (k\w+) = ([^;]+);", text):
        if "?" not in expr:
            env[name] = int(eval(expr, {}, dict(env)))  # integer arithmetic of earlier ones
    return env


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


@functools.lru_cache(maxsize=256)
def plan(b: int, q: int, g: int, path: Optional[str] = None) -> Dict[str, object]:
    """The kernel's plan for B problems of Q × G (Q ≥ 1), as the source
    computes it: the threads that solve (the smallest power of two ≥
    ⌈Q / kCols⌉, at least 32, at most kMaxThreads) and the block's (at
    least kStageThreads, which stage the costs), the columns a solving
    thread takes at a time in a step's pass (the smallest power of two ≥
    ⌈Q / threads⌉, at most kBatch), the route ("shared": the costs,
    transposed with row stride Q | 1, and the state in shared memory;
    else "workspace"), whether the state sits in shared memory, the
    dynamic shared memory and the workspace bytes."""
    k = source_constants(path)
    limit = k["kSmemLimit"] - k["kStaticSmem"]
    cost = _round_up(4 * g * (q | 1), 16)
    state = _round_up(k["kBytesPerCol"] * q + k["kBytesPerRow"] * g, 16)
    threads = 32
    while threads * k["kCols"] < q and threads < k["kMaxThreads"]:
        threads *= 2
    block = max(threads, k["kStageThreads"])
    batch = 1
    while batch < -(-q // threads) and batch < k["kBatch"]:
        batch *= 2
    shared, state_smem = cost + state <= limit, state <= limit
    tiles = 4 * (block // 32) * k["kTile"] * (k["kTile"] + 1)
    out = {"threads": threads, "block": block, "batch": batch}
    if shared:
        return {**out, "route": "shared", "state_smem": True, "smem_bytes": cost + state,
                "workspace_bytes": 0}
    ws = _round_up(b * cost, k["kAlign"])
    if not state_smem:
        ws += b * _round_up(state, k["kAlign"])
    return {**out, "route": "workspace", "state_smem": state_smem,
            "smem_bytes": max(state if state_smem else 0, tiles), "workspace_bytes": ws}


def kernel_plan(b: int, q: int, g: int) -> Dict[str, object]:
    """The built library's own plan (`efg_device_match_plan`), in `plan`'s
    form."""
    lib = _lib()
    threads, block, batch, costs, state = (ctypes.c_int(0) for _ in range(5))
    smem, ws = ctypes.c_longlong(0), ctypes.c_longlong(0)
    err = lib.efg_device_match_plan(b, q, g, ctypes.byref(threads), ctypes.byref(block),
                                    ctypes.byref(batch), ctypes.byref(smem), ctypes.byref(costs),
                                    ctypes.byref(state), ctypes.byref(ws))
    if err:
        _build.check(lib, err, "device_match plan")
    return {"threads": threads.value, "block": block.value, "batch": batch.value,
            "route": "shared" if costs.value else "workspace", "state_smem": bool(state.value),
            "smem_bytes": smem.value, "workspace_bytes": ws.value}


def _device_match_cuda(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    dev = cost.device
    if gt_mask.device != dev:
        raise ValueError(f"gt_mask is on {gt_mask.device}, the costs on {dev}")
    if cost.dim() != 3 or gt_mask.shape != (cost.shape[0], cost.shape[2]):
        raise ValueError(f"cost {tuple(cost.shape)} and gt_mask {tuple(gt_mask.shape)}: "
                         "expected [B, Q, G] and [B, G]")
    cost = cost.detach()
    if cost.dtype != torch.float32:
        cost = cost.float()
    cost = cost.contiguous()
    mask = gt_mask.detach()
    if mask.dtype != torch.bool:
        mask = mask != 0
    mask = mask.contiguous()
    b, q, g = cost.shape
    if q == 0:  # no column is ever free: every row is skipped
        return torch.full((b, g), -1, dtype=torch.int64, device=dev)
    out = torch.empty((b, g), dtype=torch.int64, device=dev)
    ws_bytes = plan(b, q, g)["workspace_bytes"]
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
    lib = _lib()
    err = lib.efg_device_match(dev.index or 0, cost.data_ptr(), mask.data_ptr(), out.data_ptr(),
                               None if ws is None else ws.data_ptr(), ws_bytes, b, q, g,
                               ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev.index)))
    if err:
        _build.check(lib, err, "device_match launch")
    launches["device_match"] += 1
    return out


def _lib():
    return _build.load("device_match", _SIGNATURES["device_match"])


def block_threads(q: int) -> int:
    """The built kernel's threads that solve Q columns."""
    return kernel_plan(1, q, 1)["threads"]


def argmin_chain(threads: int, iters: int, device) -> torch.Tensor:
    """Launch the kernel's block argmin `iters` times in a dependent chain
    in one block of `threads` (its per-step latency, for the solve's
    serial floor). Not a launch of the solver: `launches` does not move."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    out = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.efg_argmin_chain(dev.index or 0, threads, iters, out.data_ptr(),
                               ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev.index)))
    if err:
        _build.check(lib, err, "argmin_chain launch")
    return out


def device_match(cost: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """[B, Q, G] cost + [B, G] mask → [B, G] int64 query per valid GT (−1
    pad), on the cost's device. A CUDA tensor launches the kernel (no host
    copy, no synchronisation), a CPU tensor runs the plain version."""
    if cost.is_cuda:
        return _device_match_cuda(cost, gt_mask)
    if cost.device.type == "cpu":
        return device_match_plain(cost, gt_mask)
    raise ValueError(f"no device_match for device {cost.device}")
