"""Port parity: the Hungarian matcher's backends and `device_match`
(efg_tpu_torch/ops/matcher.py, ops/cuda/match_kernels.py) against
efg_tpu's (efg_tpu/ops/matcher.py), on the CPU.

The plain `device_match` (the kernel's CPU version, step for step) gives
efg_tpu's jitted `device_match` assignments bit for bit on
tests/test_device_match.py's cases and on the kernel's hazards (more GTs
than queries, every mask empty, one valid GT, integer costs full of ties,
nan and ±inf, Q of 1, 31 and 33, G of 1), and scipy's optimum in total
cost. The backend rule: `auto` on the CPU is the host solver, `device` the
plain version, each with the other route unreachable. The kernel's launch
shape, shared-memory sizing and block argmin are read from
`csrc/device_match.cu` and modelled in numpy; chip_smoke.py's copy of the
hazard set equals this one.
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


# The kernel's hazards, as chip_smoke.py's MATCH_HAZARDS makes them (which
# also runs them through the kernel on the card); the last three are run
# here only for the equality of the two copies.
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
}
SMALL = ("g_over_q", "masks_empty", "one_valid", "int_ties", "nonfinite", "q1", "q31_g1", "q33")

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
# the kernel's plan, read from its source
# ---------------------------------------------------------------------------


def _constants():
    text = (ROOT / "efg_tpu_torch" / "csrc" / "device_match.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr (?:int|long long) (k\w+) = ([^;]+);", text):
        env[name] = eval(expr, {}, dict(env))  # integer arithmetic of earlier constants
    return text, env


def _state_bytes(env, q, g):
    raw = env["kBytesPerCol"] * q + env["kBytesPerRow"] * g
    return -(-raw // 16) * 16


def test_kernel_layout_fits_the_h100():
    """The per-problem state (v, spc, row4col, path: 4 bytes a column;
    remaining: 1; u, col4row: 4 bytes a row; in_tree: 1) sits in shared
    memory up to the largest Q that fits beside the static part, within
    the H100's 227 KB; every larger Q takes the workspace route."""
    text, env = _constants()
    assert env["kSmemLimit"] == H100_SMEM and env["kMaxThreads"] == 512
    assert env["kBytesPerCol"] == 17 and env["kBytesPerRow"] == 9
    assert "state_bytes(q, g) <= kSmemLimit - kStaticSmem" in text
    # the static shared memory: the warps' (value, index) pairs and 5 scalars
    static = 2 * 4 * (env["kMaxThreads"] // 32) + 5 * 4
    assert static <= env["kStaticSmem"]
    for g in (1, 100, 256, 1024):
        limit = env["kSmemLimit"] - env["kStaticSmem"]
        q_max = (limit - env["kBytesPerRow"] * g) // 17
        while _state_bytes(env, q_max + 1, g) <= limit:
            q_max += 1
        assert _state_bytes(env, q_max, g) <= env["kSmemLimit"] - env["kStaticSmem"]
        assert _state_bytes(env, q_max, g) + static <= H100_SMEM
        assert _state_bytes(env, q_max + 1, g) > env["kSmemLimit"] - env["kStaticSmem"]
    # the hazards' routes: ConQueR's Q 1000 and 3000 in shared memory (the
    # latter above 48 KB: the opt-in), the 14000 × 8 case in the workspace
    limit = env["kSmemLimit"] - env["kStaticSmem"]
    assert _state_bytes(env, 1000, 256) <= 48 * 1024 < _state_bytes(env, 3000, 256) <= limit
    assert _state_bytes(env, 14000, 8) > limit
    assert "if (smem > 48 * 1024 && !opted_in)" in text
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize,\n                               kSmemLimit - kStaticSmem" in text
    assert "(q + 31) / 32 * 32" in text


def _block_threads(q, max_threads=512):
    return min(-(-q // 32) * 32, max_threads)


def _before(a, ai, b, bi):
    return a < b or (a == b and ai < bi)


def block_argmin(vals, nt):
    """The kernel's block argmin in numpy: each thread's strided columns,
    the warps' shuffle-down trees (an out-of-range lane keeps its own
    value), then thread 0 over the warps in order."""
    inf = np.float32(np.inf)
    best = [inf] * nt
    idx = [2 ** 31 - 1] * nt
    for t in range(nt):
        for j in range(t, len(vals), nt):
            if _before(vals[j], j, best[t], idx[t]):
                best[t], idx[t] = vals[j], j
    for w in range(nt // 32):
        lanes = list(range(32 * w, 32 * w + 32))
        for off in (16, 8, 4, 2, 1):
            snap = [(best[t], idx[t]) for t in lanes]
            for k, t in enumerate(lanes):
                ov, oi = snap[k + off] if k + off < 32 else snap[k]
                if _before(ov, oi, best[t], idx[t]):
                    best[t], idx[t] = ov, oi
    b, i = best[0], idx[0]
    for w in range(1, nt // 32):
        if _before(best[32 * w], idx[32 * w], b, i):
            b, i = best[32 * w], idx[32 * w]
    return i, b


@pytest.mark.parametrize("q", [1, 31, 33, 512, 1000, 3000])
def test_block_argmin_is_jnp_argmin(q):
    """Ties to the lower index, infinities, and every entry inf (index 0),
    at Q below a warp, around it and above the block's 512 threads."""
    rs = np.random.RandomState(q)
    cases = [rs.randint(0, 3, q).astype(np.float32),
             np.where(rs.rand(q) < 0.8, np.inf, rs.randn(q)).astype(np.float32),
             np.full(q, np.inf, np.float32)]
    nt = _block_threads(q)
    for vals in cases:
        j, v = block_argmin(vals, nt)
        want = int(jnp.argmin(jnp.asarray(vals)))
        assert j == want and v == vals[want]


def test_chip_smoke_hazards_are_these():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert list(cs.MATCH_HAZARDS) == list(MATCH_HAZARDS)
    for name, make in MATCH_HAZARDS.items():
        for a, b in zip(cs.MATCH_HAZARDS[name](), make()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
