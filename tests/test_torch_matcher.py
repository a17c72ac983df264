"""Port parity: the Hungarian matcher's backends and `device_match`
(efg_tpu_torch/ops/matcher.py, ops/cuda/match_kernels.py) against
efg_tpu's (efg_tpu/ops/matcher.py), on the CPU.

The plain `device_match` (the kernel's CPU version, step for step) gives
efg_tpu's jitted `device_match` assignments bit for bit on
tests/test_device_match.py's cases and on the kernel's hazards (more GTs
than queries, every mask empty, one valid GT, integer costs full of ties,
nan and ±inf, Q of 1, 31 and 33, G of 1), and scipy's optimum in total
cost. The backend rule: `auto` on the CPU is the host solver, `device` the
plain version, each with the other route unreachable. The kernel's plan
(threads, routes, shared memory) is read from `csrc/device_match.cu`'s
`constexpr` lines, and its schedule (the staging walks, the valid list,
the assigned count, the fused first step, the one-barrier argmin, the
tree list and the dual updates) is modelled in numpy and held bit for bit
against efg_tpu and the plain version, at the source's plan and at the
thread plans tools/port_kernel_sweep.py times, the route boundary
included; chip_smoke.py's copy of the hazard set equals this one.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops import matcher as JM
from efg_tpu_torch.ops import matcher as TM
from efg_tpu_torch.ops.cuda import match_kernels as MK

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H100_SMEM = 232448  # bytes of shared memory a block may use on the H100 (227 KB)


def _randn(seed, b, q, g, p_valid=0.7, scale=5.0):
    rs = np.random.RandomState(seed)
    cost = (rs.randn(b, q, g) * scale).astype(np.float32)
    return cost, rs.rand(b, g) < p_valid


def _one_valid():
    cost, mask = _randn(3, 2, 33, 16)
    mask[:] = False
    mask[0, 7] = mask[1, 0] = True
    return cost, mask


def _int_ties():
    rs = np.random.RandomState(4)
    return rs.randint(0, 3, size=(3, 31, 12)).astype(np.float32), np.ones((3, 12), bool)


def _nonfinite():
    cost, mask = _randn(5, 2, 20, 6, p_valid=1.0)
    cost[0, 3, 2], cost[0, 5, 1], cost[1, 2, 3] = np.nan, np.inf, np.inf
    cost[1, :, 0] = -np.inf
    return cost, mask


def _pad_but_last():
    cost, mask = _randn(12, 2, 40, 24)
    mask[:] = False
    mask[:, -1] = True
    return cost, mask


# The kernel's hazards, as chip_smoke.py's MATCH_HAZARDS makes them (which
# also runs them through the kernel on the card); q1000_g256, q3000_g256
# and workspace are run here only for the equality of the two copies.
MATCH_HAZARDS = {
    "g_over_q": lambda: _randn(1, 2, 3, 5, p_valid=0.9),
    "masks_empty": lambda: _randn(2, 2, 8, 4, p_valid=0.0),
    "one_valid": _one_valid,
    "int_ties": _int_ties,
    "nonfinite": _nonfinite,
    "q1": lambda: _randn(6, 2, 1, 4, p_valid=1.0),
    "q31_g1": lambda: _randn(7, 3, 31, 1, p_valid=1.0),
    "q33": lambda: _randn(8, 2, 33, 40),
    "q1000_g256": lambda: _randn(9, 2, 1000, 256, p_valid=0.63),
    "q3000_g256": lambda: _randn(10, 1, 3000, 256, p_valid=0.63),
    "workspace": lambda: _randn(11, 1, 14000, 8, p_valid=1.0),
    # the route boundary: staged costs and state exactly at the block's
    # shared memory (shared route), and 16 bytes above it (workspace route)
    "smem_limit": lambda: _randn(13, 1, 1124, 47, p_valid=0.8),
    "smem_limit_over": lambda: _randn(14, 1, 1125, 47, p_valid=0.8),
    "pad_but_last": _pad_but_last,
    "q20_g12": lambda: _randn(15, 2, 20, 12, p_valid=0.9),  # Q below one warp
    "q300_g48": lambda: _randn(16, 2, 300, 48),  # Q not a multiple of the threads
}
SMALL = ("g_over_q", "masks_empty", "one_valid", "int_ties", "nonfinite", "q1", "q31_g1", "q33",
         "pad_but_last", "q20_g12", "q300_g48")
BOUNDARY = ("smem_limit", "smem_limit_over")

_jit_match = jax.jit(JM.device_match)


def _scipy_total(cost, mask):
    from scipy.optimize import linear_sum_assignment

    c = np.nan_to_num(cost.astype(np.float64), posinf=1e8, neginf=-1e8)
    tot = 0.0
    for b in range(c.shape[0]):
        cols = np.flatnonzero(mask[b])
        if cols.size:
            r, k = linear_sum_assignment(c[b][:, cols])
            tot += c[b][r, cols[k]].sum()
    return tot


def _total(cost, match):
    c = np.nan_to_num(cost.astype(np.float64), posinf=1e8, neginf=-1e8)
    b, g = np.nonzero(match >= 0)
    return c[b, match[b, g], g].sum()


def feasible(cost, mask):
    """The samples whose valid GTs all find a query: there the solve is
    scipy's optimum. With more valid GTs than queries efg_tpu's solver
    assigns the first Q rows it reaches and skips the rest (not scipy's
    best subset)."""
    return mask.sum(1) <= cost.shape[1]


def _check_plain(cost, mask):
    want = np.asarray(_jit_match(jnp.asarray(cost), jnp.asarray(mask)))
    got = MK.device_match_plain(torch.from_numpy(cost), torch.from_numpy(mask))
    assert got.dtype == torch.int64 and got.shape == mask.shape
    np.testing.assert_array_equal(got.numpy(), want)
    got = got.numpy()
    assert (got[~mask] == -1).all()
    for b in range(cost.shape[0]):
        used = got[b][got[b] >= 0]
        assert len(set(used.tolist())) == len(used) == min(int(mask[b].sum()), cost.shape[1])
    ok = feasible(cost, mask)
    assert _total(cost[ok], got[ok]) == pytest.approx(_scipy_total(cost[ok], mask[ok]), rel=1e-6,
                                                      abs=1e-3)


@pytest.mark.parametrize("q,g,seed", [(64, 7, 0), (128, 30, 1), (16, 16, 2), (6, 4, 3)])
def test_plain_device_match_is_efg_tpus(q, g, seed):
    """tests/test_device_match.py's cases: bit-equal assignments."""
    rs = np.random.RandomState(seed)
    cost = rs.randn(3, q, g).astype(np.float32) * 5.0
    n_valid = rs.randint(1, g + 1, size=3)
    _check_plain(cost, np.arange(g)[None] < n_valid[:, None])


@pytest.mark.parametrize("name", SMALL)
def test_plain_device_match_hazards(name):
    _check_plain(*MATCH_HAZARDS[name]())


def test_plain_device_match_steps():
    """The Dijkstra steps it reports: one a row where every row finds a
    free column at once (an identity-like cost), more where rows compete."""
    cost = np.full((1, 4, 4), 10.0, np.float32)
    cost[0, np.arange(4), np.arange(4)] = 0.0
    steps = []
    MK.device_match_plain(torch.from_numpy(cost), torch.ones(1, 4, dtype=torch.bool), steps)
    assert steps == [[1, 1, 1, 1]]
    steps = []
    same = np.zeros((1, 3, 3), np.float32)  # every row wants query 0 first
    MK.device_match_plain(torch.from_numpy(same), torch.ones(1, 3, dtype=torch.bool), steps)
    assert len(steps) == 1 and len(steps[0]) == 3 and sum(steps[0]) > 3


def test_auto_on_cpu_is_host(monkeypatch):
    """`auto` on a CPU tensor is efg_tpu's CPU choice, scipy: the same
    assignment as backend="host", and device_match never runs."""
    monkeypatch.delenv("EFG_MATCHER_BACKEND", raising=False)
    cost, mask = _randn(12, 3, 12, 7)

    def refuse(*a):
        raise AssertionError("device_match ran under auto on the CPU")

    monkeypatch.setattr(TM, "device_match", refuse)
    got = TM.hungarian_match(torch.from_numpy(cost), torch.from_numpy(mask))
    want = TM.hungarian_match(torch.from_numpy(cost), torch.from_numpy(mask), backend="host")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jwant = JM.hungarian_match(jnp.asarray(cost), jnp.asarray(mask), backend="host")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_device_backend_on_cpu_is_plain(monkeypatch):
    """EFG_MATCHER_BACKEND=device on a CPU tensor runs the plain version
    (efg_tpu's device_match on its CPU), never scipy, and launches no
    kernel."""
    monkeypatch.setenv("EFG_MATCHER_BACKEND", "device")
    monkeypatch.setattr(TM, "solve_batch", lambda *a: (_ for _ in ()).throw(
        AssertionError("the host solver ran under EFG_MATCHER_BACKEND=device")))
    MK.reset_launches()
    cost, mask = _int_ties()
    got = TM.hungarian_match(torch.from_numpy(cost), torch.from_numpy(mask))
    want = np.asarray(JM.hungarian_match(jnp.asarray(cost), jnp.asarray(mask), backend="device"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert MK.launches == {"device_match": 0}


def test_backend_selection(monkeypatch):
    """The argument, then set_matcher_backend, then the environment read
    at each call; `auto` by the tensor's device; unknown names raise."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    monkeypatch.delenv("EFG_MATCHER_BACKEND", raising=False)
    assert TM.resolve_backend(None, cuda) == "device"
    assert TM.resolve_backend(None, cpu) == "host"
    assert TM.resolve_backend("host", cuda) == "host"
    monkeypatch.setenv("EFG_MATCHER_BACKEND", "host")
    assert TM.resolve_backend(None, cuda) == "host"
    assert TM.resolve_backend("device", cpu) == "device"
    try:
        TM.set_matcher_backend("device")
        assert TM.resolve_backend(None, cpu) == "device"
        assert TM.resolve_backend("auto", cpu) == "host"
    finally:
        TM.set_matcher_backend(None)
    assert TM.resolve_backend(None, cpu) == "host"
    monkeypatch.setenv("EFG_MATCHER_BACKEND", "gpu")
    with pytest.raises(ValueError, match="EFG_MATCHER_BACKEND"):
        TM.hungarian_match(torch.zeros(1, 3, 2), torch.ones(1, 2, dtype=torch.bool))
    with pytest.raises(ValueError):
        TM.set_matcher_backend("cuda")
    with pytest.raises(ValueError, match="no device_match"):
        MK.device_match(torch.zeros(1, 3, 2, device="meta"), torch.ones(1, 2, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the kernel's plan and schedule, read from its source and modelled in numpy
# ---------------------------------------------------------------------------

SOURCE = ROOT / "efg_tpu_torch" / "csrc" / "device_match.cu"
KNONE = 0xFFFFFFFF
# the (kCols, kMaxThreads) of the plans tools/port_kernel_sweep.py times
THREAD_PLANS = ((1, 512), (1, 128), (1, 256), (1, 1024), (2, 512), (4, 512))


def _constants():
    return SOURCE.read_text(), MK.source_constants(str(SOURCE))


def _threads(q, cols, max_threads):
    """The threads that solve Q columns: the smallest power of two ≥
    ⌈Q / cols⌉, at least a warp, at most max_threads."""
    t = 32
    while t * cols < q and t < max_threads:
        t *= 2
    return t


def order_key(x):
    """The kernel's order-preserving key of f32 values (−0 as +0)."""
    b = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def key_value(k):
    k = np.uint32(k)
    return (np.uint32(k & 0x7FFFFFFF) if k & 0x80000000 else np.uint32(~k)).view(np.float32)


class BlockArgmin:
    """The kernel's one-barrier argmin of the solving threads in numpy:
    each thread's columns j = t + k·threads in order (a strictly smaller
    value replaces), a warp's two minimums (the key, then the lowest index
    holding it); with several warps lane 0's slot in the array of the
    step's parity, the barrier, every warp's two minimums over the slots.
    A slot array is written again only two steps after it was read, with a
    barrier between (asserted)."""

    def __init__(self, threads):
        self.nt, self.nwarps = threads, threads // 32
        self.slots = np.full((2, 32, 2), KNONE, np.uint64)
        self.read_at = [-2, -2]
        self.step = 0

    def __call__(self, keys, idxs):
        nt, q = self.nt, len(keys)
        k_cols = -(-q // nt)
        kk = np.full(k_cols * nt, KNONE, np.uint64)
        ii = np.full(k_cols * nt, KNONE, np.uint64)
        kk[:q], ii[:q] = keys, idxs
        kk, ii = kk.reshape(k_cols, nt), ii.reshape(k_cols, nt)
        tk, ti = np.full(nt, KNONE, np.uint64), np.full(nt, KNONE, np.uint64)
        for k in range(k_cols):
            better = kk[k] < tk
            tk, ti = np.where(better, kk[k], tk), np.where(better, ii[k], ti)
        tk, ti = tk.reshape(self.nwarps, 32), ti.reshape(self.nwarps, 32)
        wk = tk.min(1)
        wi = np.where(tk == wk[:, None], ti, KNONE).min(1)
        if self.nwarps == 1:  # one solving warp: no slots, no barrier
            return int(wk[0]), int(wi[0])
        parity = self.step & 1
        assert self.step - self.read_at[parity] >= 2, "a slot written before its last read"
        self.slots[parity, :self.nwarps, 0], self.slots[parity, :self.nwarps, 1] = wk, wi
        # the barrier; then every warp reads its lanes' slots (lane < nwarps)
        sk, si = self.slots[parity, :self.nwarps, 0], self.slots[parity, :self.nwarps, 1]
        key = sk.min()
        idx = np.where(sk == key, si, KNONE).min()
        self.read_at[parity] = self.step
        self.step += 1
        return int(key), int(idx)


def stage(c, route, threads):
    """The kernel's staged costs [G, Q] (row stride Q | 1, nan_to_num) by
    its index walk: on the shared route each thread's flat [Q, G] index
    with (q, g) carried without division, on the workspace route 32 × 32
    tiles; every element written exactly once (asserted)."""
    q, g = c.shape
    stride = q | 1
    flat = np.nan_to_num(c, nan=0.0, posinf=1e8, neginf=-1e8).astype(np.float32).reshape(-1)
    buf = np.zeros(g * stride, np.float32)
    writes = np.zeros(g * stride, np.int64)
    if route == "shared":
        t = np.arange(threads)
        dq, dg = threads // g, threads - (threads // g) * g
        qi, gi, k = t // g, t - (t // g) * g, t.copy()
        while (k < q * g).any():
            live = k < q * g
            at = gi[live] * stride + qi[live]
            buf[at] = flat[k[live]]
            np.add.at(writes, at, 1)
            gi, qi, k = gi + dg, qi + dq, k + threads
            wrap = gi >= g
            gi, qi = np.where(wrap, gi - g, gi), np.where(wrap, qi + 1, qi)
    else:
        src = flat.reshape(q, g)
        for q0 in range(0, q, 32):
            for g0 in range(0, g, 32):
                tile = src[q0:q0 + 32, g0:g0 + 32]  # read by rows: lane = g
                rows = (g0 + np.arange(tile.shape[1]))[:, None] * stride
                at = (rows + q0 + np.arange(tile.shape[0])[None]).reshape(-1)
                buf[at] = tile.T.reshape(-1)  # written by rows: lane = q
                np.add.at(writes, at, 1)
    written = writes.reshape(g, stride)
    assert (written[:, :q] == 1).all() and (written[:, q:] == 0).all()
    return buf.reshape(g, stride)[:, :q]


def model_problem(c, valid, threads, route, block):
    """One problem through the kernel's schedule: the valid list (ballots),
    the assigned count for the skip rule, the fused first step with the
    previous row's dual update of v for its removed columns, the
    one-barrier argmin, the tree list with the u update over it alone, the
    walk that counts the columns it fills."""
    q, g = c.shape
    f32, inf = np.float32, np.float32(np.inf)
    cst = stage(c, route, block)
    v, spc, u = np.zeros(q, f32), np.zeros(q, f32), np.zeros(g, f32)
    row4col, path = np.full(q, -1, np.int64), np.zeros(q, np.int64)
    col4row = np.full(g, -1, np.int64)
    remaining, in_tree = np.ones(q, bool), np.zeros(g, bool)
    vlist = []
    for k0 in range(0, g, 32):  # warp 0's ballots
        ok = valid[k0:k0 + 32]
        pos = len(vlist) + np.cumsum(ok) - ok
        vlist.extend(int(k0 + lane) for lane in np.flatnonzero(ok))
        assert list(pos[ok]) == list(range(len(vlist) - int(ok.sum()), len(vlist)))
    argmin = BlockArgmin(threads)
    cols = np.arange(q, dtype=np.uint64)
    assigned, prev_min = 0, f32(0.0)
    for cur in vlist:
        if assigned >= q:
            break
        tree = [cur]
        in_tree[cur] = True
        removed = ~remaining  # the previous row's removed columns: v −= min − spc
        v = np.where(removed, v - (prev_min - spc), v).astype(f32)
        remaining[:] = True
        r = ((f32(0.0) + cst[cur]) - u[cur]) - v
        upd = r < inf
        spc, path = np.where(upd, r, inf).astype(f32), np.where(upd, cur, 0)
        keys, idxs = order_key(spc), cols << np.uint64(1) | np.uint64(1)
        i, sink, steps, nrem = cur, -1, 0, q
        while True:
            key, idx = argmin(keys, idxs)
            j, min_val = idx >> 1, key_value(key)
            if idx & 1:
                nrem -= 1
                remaining[j] = False  # by j's own thread
            owner = int(row4col[j])
            if owner < 0:
                sink = j
            else:
                i = owner
            steps += 1
            if not (sink < 0 and nrem > 0 and steps <= g):
                break
            if not in_tree[i]:
                in_tree[i] = True
                tree.append(i)
            r = ((min_val + cst[i]) - u[i]) - v
            upd = remaining & (r < spc)
            spc, path = np.where(upd, r, spc).astype(f32), np.where(upd, i, path)
            masked = np.where(remaining, spc, inf).astype(f32)
            keys = order_key(masked)
            idxs = cols << np.uint64(1) | remaining.astype(np.uint64)
        u[cur] = u[cur] + min_val
        for k in tree:  # the dual update of u over the tree list alone
            in_tree[k] = False
            if k != cur:
                u[k] = u[k] + (min_val - spc[min(max(int(col4row[k]), 0), q - 1)])
        j, done, s, filled = sink, sink < 0, 0, 0
        while not done and s <= g:
            jc = j + q if j < 0 else j
            r_ = int(path[jc])
            filled += int(row4col[jc] < 0)
            row4col[jc] = r_
            nxt = int(col4row[r_])
            col4row[r_] = j
            done, j, s = r_ == cur, nxt, s + 1
        assigned += filled
        assert assigned == int((row4col >= 0).sum())
        prev_min = min_val
    return np.where(valid, col4row, -1)


def kernel_model(cost, mask, thread_plan=None):
    """[B, Q, G] → [B, G] through `model_problem`, at the plan's solving
    threads (the source's kCols and kMaxThreads unless `thread_plan`
    names others), block and route."""
    b, q, g = cost.shape
    if q == 0:
        return np.full((b, g), -1, np.int64)
    plan = MK.plan(b, q, g, str(SOURCE))
    threads = plan["threads"] if thread_plan is None else _threads(q, *thread_plan)
    block = max(threads, plan["block"])
    return np.stack([model_problem(cost[k], mask[k], threads, plan["route"], block)
                     for k in range(b)]) if b else np.zeros((0, g), np.int64)


def _check_model(cost, mask, thread_plan=None):
    want = np.asarray(_jit_match(jnp.asarray(cost), jnp.asarray(mask)))
    got = kernel_model(cost, mask, thread_plan)
    np.testing.assert_array_equal(got, want)
    plain = MK.device_match_plain(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("name", SMALL + BOUNDARY)
def test_kernel_model_hazards(name):
    """The kernel's schedule gives efg_tpu's and the plain version's
    assignment bit for bit on every hazard small enough for the CPU,
    the two shapes at the route boundary included."""
    _check_model(*MATCH_HAZARDS[name]())


@pytest.mark.parametrize("q,g,seed", [(64, 7, 0), (128, 30, 1), (16, 16, 2), (6, 4, 3)])
def test_kernel_model_random(q, g, seed):
    rs = np.random.RandomState(seed)
    cost = rs.randn(3, q, g).astype(np.float32) * 5.0
    n_valid = rs.randint(1, g + 1, size=3)
    _check_model(cost, np.arange(g)[None] < n_valid[:, None])


@pytest.mark.parametrize("thread_plan", THREAD_PLANS, ids=[f"c{c}_t{t}" for c, t in THREAD_PLANS])
def test_kernel_model_thread_plans(thread_plan):
    """Each thread plan the sweep times: ties across threads and warps
    (integer costs), Q not a multiple of the threads, one solving warp and
    several."""
    for name in ("int_ties", "q300_g48", "q33"):
        _check_model(*MATCH_HAZARDS[name](), thread_plan=thread_plan)


@pytest.mark.parametrize("route", ["shared", "workspace"])
@pytest.mark.parametrize("q,g", [(1, 4), (31, 1), (33, 40), (100, 100), (300, 48), (64, 7)])
def test_staging_writes_every_cost_once(route, q, g):
    """Both staging walks, by the plan's block, write every [G, Q] element
    once, transposed, and never the stride's padding column."""
    rs = np.random.RandomState(q * 1000 + g)
    c = rs.randn(q, g).astype(np.float32)
    c[0, 0], c[-1, -1] = np.nan, -np.inf
    got = stage(c, route, MK.plan(1, q, g, str(SOURCE))["block"])
    np.testing.assert_array_equal(got, np.nan_to_num(c.T, nan=0.0, posinf=1e8, neginf=-1e8))


# the shapes whose plans are checked: Mask2Former's solve, ConQueR's, the
# hazards' routes
PLAN_SHAPES = {
    "mask2former": ((20, 100, 100), "shared", True),
    "conquer": ((8, 1000, 256), "workspace", True),
    "q3000_g256": ((1, 3000, 256), "workspace", True),
    "workspace": ((1, 14000, 8), "workspace", False),
    "smem_limit": ((1, 1124, 47), "shared", True),
    "smem_limit_over": ((1, 1125, 47), "workspace", True),
}


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_kernel_layout_fits_the_h100(name):
    """The plan read from the source's constexpr lines: the staged costs
    (4·G·(Q | 1) bytes) and the state (17 bytes a column: v, spc, row4col,
    path, remaining; 17 a row: u, col4row, the valid and tree lists,
    in_tree) in shared memory where they fit beside the static part
    within the H100's 227 KB, else the costs in the workspace (the state
    too beyond ~13.5k queries); smem_limit sits exactly at the limit."""
    text, env = _constants()
    assert env["kSmemLimit"] == H100_SMEM and env["kBytesPerCol"] == env["kBytesPerRow"] == 17
    assert (env["kCols"], env["kMaxThreads"]) in THREAD_PLANS and env["kTile"] == 32
    assert env["kStageThreads"] % 32 == 0 and env["kBatch"] in (4, 8, 16)
    static = 2 * 32 * 8 + 2 * 4  # the slots' (key, index) pairs, two arrays; two scalars
    assert static <= env["kStaticSmem"]
    limit = env["kSmemLimit"] - env["kStaticSmem"]
    (b, q, g), route, state_smem = PLAN_SHAPES[name]
    plan = MK.plan(b, q, g, str(SOURCE))
    assert (plan["route"], plan["state_smem"]) == (route, state_smem)
    # the solving threads (each holding kCols columns, up to kMaxThreads) in
    # a block of at least kStageThreads; a step's pass: each thread's
    # ⌈Q / threads⌉ columns, loaded at most kBatch at a time
    assert plan["threads"] == _threads(q, env["kCols"], env["kMaxThreads"])
    assert plan["block"] == max(plan["threads"], env["kStageThreads"])
    assert plan["batch"] >= min(-(-q // plan["threads"]), env["kBatch"]) > plan["batch"] // 2
    assert plan["smem_bytes"] + static <= H100_SMEM and plan["smem_bytes"] <= limit
    assert (plan["workspace_bytes"] == 0) == (route == "shared")
    cost = -(-4 * g * (q | 1) // 16) * 16
    state = -(-17 * (q + g) // 16) * 16
    assert (cost + state <= limit) == (route == "shared")
    if name == "smem_limit":
        assert cost + state == limit
    for snippet in ("return q | 1;", "cost_bytes(q, g) + state_bytes(q, g) <= kSmemLimit - "
                    "kStaticSmem", "while (t * kCols < q && t < kMaxThreads) t *= 2;",
                    "return solve_threads(q) > kStageThreads ? solve_threads(q) : kStageThreads;",
                    "if (tid >= nt) return;  // the warps that only staged",
                    "if (ws_bytes < workspace_bytes(b, q, g)) return cudaErrorInvalidValue;",
                    "device_match_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
                    "        kSmemLimit - kStaticSmem);", "while (kb < k && kb < kBatch) kb *= 2;"):
        assert snippet in text, snippet


@pytest.mark.parametrize("q", [1, 31, 33, 512, 1000, 3000])
def test_block_argmin_is_jnp_argmin(q):
    """The one-barrier reduction at each thread plan: ties to the lower
    index across lanes, warps and a thread's columns, −0 against +0,
    infinities, every entry inf (index 0), at Q below a warp, around it
    and above the block's threads; the index's low bit carries the
    column's remaining flag through."""
    rs = np.random.RandomState(q)
    cases = [rs.randint(0, 3, q).astype(np.float32),
             np.where(rs.rand(q) < 0.8, np.inf, rs.randn(q)).astype(np.float32),
             np.full(q, np.inf, np.float32),
             np.where(rs.rand(q) < 0.5, np.float32(-0.0), np.float32(0.0)).astype(np.float32)]
    for thread_plan in THREAD_PLANS:
        argmin = BlockArgmin(_threads(q, *thread_plan))
        for vals in cases:
            flags = (rs.rand(q) < 0.5).astype(np.uint64)
            key, idx = argmin(order_key(vals), np.arange(q, dtype=np.uint64) << np.uint64(1) | flags)
            want = int(jnp.argmin(jnp.asarray(vals)))
            assert idx >> 1 == want and idx & 1 == flags[want]
            assert key_value(key) == vals[want]


def test_chip_smoke_hazards_are_these():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert list(cs.MATCH_HAZARDS) == list(MATCH_HAZARDS)
    for name, make in MATCH_HAZARDS.items():
        for a, b in zip(cs.MATCH_HAZARDS[name](), make()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
