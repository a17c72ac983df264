"""Port parity: the default rank kernel's warp schedule.

`csrc/rank_flags.cu` (replaces efg_tpu's `_rank_kernel_seq`) gives each
warp 128 consecutive queries (four a lane), brackets the lower bounds of
their smallest and largest with one warp search, and, where the keys
between fit 256, copies them into the warp's slice of shared memory and
resolves every query by a branch-free halving there; a wider span is
searched lane by lane in device memory; padding queries take the count of
keys below CLAMP_Q. A CUDA kernel cannot run here, so a numpy model of that
schedule, reading only the keys the kernel reads, is held bit for bit
against efg_tpu's Pallas `_rank_kernel_seq` (interpret mode) and against
the plain version `rank_flags_plain`, on the hazard cases of the rank
kernels (chip_smoke.py's `RANK_EDGE_CASES`), on the rulebooks the port
builds, and on spans at the window's edge and past it. The kernel itself is
held against the plain version on the card by chip_smoke.py."""

import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops.pallas import sparse_kernels as PK
from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.ops.cuda import sparse_kernels as K

from test_torch_sparse_kernels import both_tensors, sites
from test_torch_sparse_variants import LANES, RANK_CASES, _max_rounds

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PK.set_interpret(True)

ROOT = Path(__file__).resolve().parents[1]
INVALID_Q, CLAMP_Q = K.INVALID_Q, K.CLAMP_Q
INT_MIN, INT_MAX = -(2**31), 2**31 - 1
# csrc/rank_flags.cu: queries per lane, keys of a warp's window in shared
# memory (a power of two), keys the span search may leave unknown
PER_LANE, WINDOW, SLACK = 4, 256, 32
RUN = LANES * PER_LANE


class Reads:
    """The key indices the model reads from device memory, and its counts
    of warp-search rounds and of warps that took the wide path."""

    def __init__(self, vk):
        self.vk, self.top, self.low = vk, -1, 0
        self.rounds = self.windows = self.wide = 0

    def key(self, kc, i):
        i = np.asarray(i)
        if i.size:
            self.top, self.low = max(self.top, int(i.max())), min(self.low, int(i.min()))
        return kc[i]


def warp_lower_bounds(kc, q, lo, hi, reads, slack=0):
    """rank_walk.cuh `warp_lower_bounds` in numpy: every target's segments
    probed in the same rounds, until at most `slack` keys of each are
    unknown (a target with lo == hi asks nothing). Returns (lo, hi): each
    lower bound lies in [lo, hi]."""
    lo, hi = list(lo), list(hi)
    while any(h - l > slack for l, h in zip(lo, hi)):
        reads.rounds += 1
        for i in range(len(q)):
            if hi[i] - lo[i] <= slack:
                continue
            step = -(-(hi[i] - lo[i]) // LANES)
            idx = lo[i] + (np.arange(LANES) + 1) * step - 1
            on = idx < hi[i]
            lt = np.zeros(LANES, bool)
            lt[on] = reads.key(kc, idx[on]) < q[i]
            c = int(lt.sum())
            assert lt[:c].all()  # the ballot is a prefix
            lo[i] += c * step
            hi[i] = min(lo[i] + step - 1, hi[i])
    return lo, hi


def lower_bound(keys_at, lo, n, q):
    """The first of positions [lo, lo + n) whose key is >= q (lo + n if
    none), by halving as the kernel's device-memory search does."""
    while n > 0:
        half = n >> 1
        if keys_at(lo + half) < q:
            lo, n = lo + half + 1, n - half - 1
        else:
            n = half
    return lo


def window_lower_bound(win, q):
    """The kernel's branch-free search of the window: 1 + the count of keys
    < q at positions [1, WINDOW), by steps WINDOW/2, ..., 1 of one load and
    one select (every position past the span holds CLAMP_Q)."""
    lo, step = 0, WINDOW // 2
    while step >= 1:
        lo = lo + step if win[lo + step] < q else lo
        step //= 2
    return lo + 1


def warp_model(kc, qs, n_valid, reads):
    """One warp's RUN queries (those past n_valid read as padding and are
    dropped by the caller); returns the packed results."""
    vk = len(kc)
    live = np.arange(RUN) < n_valid
    pad = (qs >= INVALID_Q) & live
    q = np.where(qs >= INVALID_Q, CLAMP_Q, qs).astype(np.int64)
    valid = q < CLAMP_Q
    any_valid, any_pad = bool(valid.any()), bool(pad.any())
    targets = [int(q[valid].min()), int(q[valid].max())] if any_valid else [0, 0]
    lb, ub = warp_lower_bounds(kc, targets + [CLAMP_Q], [0, 0, 0],
                               [vk if any_valid else 0] * 2 + [vk if any_pad else 0], reads,
                               SLACK)
    l0, l1 = lb[0], ub[1]  # every lower bound of the warp lies in [l0, l1]
    if any_pad and ub[2] > lb[2]:  # CLAMP_Q's, exactly
        lb[2] = warp_lower_bounds(kc, [CLAMP_Q], [lb[2]], [ub[2]], reads)[0][0]
    below = lb[2]
    res = np.zeros(RUN, np.int64)
    if any_pad:
        fm = below > 0 and int(reads.key(kc, below - 1)) == CLAMP_Q - 1
        res[:] = below * 8 + fm * 4 + (below < vk) * 2
    if not any_valid:
        return res
    hi = min(l1, vk)
    if l1 - l0 <= WINDOW - 3:  # the window in shared memory: keys [l0 − 1, l1 + 2)
        reads.windows += 1
        w0, need = l0 - 1, l1 - l0 + 3
        idx = w0 + np.arange(need)
        inside = (idx >= 0) & (idx < vk)
        win = np.full(WINDOW, CLAMP_Q, np.int64)
        win[:need][inside] = reads.key(kc, idx[inside])
        assert (np.diff(win[1:]) >= 0).all()  # sorted: the halving is a count
        for e in np.nonzero(valid)[0]:
            pos = window_lower_bound(win, q[e])
            assert pos == lower_bound(lambda j: win[j], 1, hi - l0, q[e])
            p = w0 + pos
            f0 = p < vk and win[pos] == q[e]
            fm = p > 0 and win[pos - 1] == q[e] - 1
            fp = p + f0 < vk and win[pos + f0] == q[e] + 1
            res[e] = p * 8 + fm * 4 + f0 * 2 + fp
    else:  # a wide span: each lane searches keys [l0, hi) in device memory
        reads.wide += 1
        for e in np.nonzero(valid)[0]:
            p = lower_bound(lambda i: int(reads.key(kc, i)), l0, hi - l0, q[e])
            fm = p > 0 and int(reads.key(kc, p - 1)) == q[e] - 1
            f0 = p < vk and int(reads.key(kc, p)) == q[e]
            fp = p + f0 < vk and int(reads.key(kc, p + f0)) == q[e] + 1
            res[e] = p * 8 + fm * 4 + f0 * 2 + fp
    return res


def rank_block_model(keys, queries):
    """rank_flags.cu in numpy over the flat queries, warp by warp (lane l
    holding queries l and l + 32 of its warp's 64). Returns (packed [P, Vq]
    int32, Reads)."""
    kc = np.minimum(keys.astype(np.int64), CLAMP_Q)
    flat = queries.reshape(-1).astype(np.int64)
    n = len(flat)
    reads = Reads(len(keys))
    out = np.zeros(n, np.int64)
    for base in range(0, n, RUN):
        m = min(RUN, n - base)
        qs = np.full(RUN, INVALID_Q, np.int64)
        qs[:m] = flat[base:base + m]
        out[base:base + m] = warp_model(kc, qs, m, reads)[:m]
    return out.reshape(queries.shape).astype(np.int32), reads


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _sparse_rows_case():
    """Rows of 600 queries spread over 200 000 keys (about 330 keys between
    neighbours): every warp's span is wide, and its lanes search it in
    device memory."""
    rs = np.random.RandomState(31)
    keys = np.sort(rs.choice(4_000_000, 200_000, replace=False)).astype(np.int32)
    queries = np.sort(rs.choice(4_000_000, 600, replace=False)).astype(np.int32)
    return keys, np.stack([queries, queries + 1])


def _window_edge_case():
    """Queries 1, 2 and 3 keys apart, rows of four warps: a warp's span is
    127 keys (in the window), 254 (one past it) and 381."""
    keys = np.arange(19400, dtype=np.int32)
    return keys, np.stack([17800 + d * np.arange(512) for d in (1, 2, 3)]).astype(np.int32)


def _short_rows_case():
    """Rows of 37 queries: most warps' 64 queries cross a row, so their
    span is wide."""
    rs = np.random.RandomState(33)
    keys = np.sort(rs.choice(50000, 9000, replace=False)).astype(np.int32)
    rows = [np.sort(rs.choice(50000, 37, replace=False)) for _ in range(20)]
    return keys, np.stack(rows).astype(np.int32)


EXTRA_CASES = {"sparse_rows": _sparse_rows_case, "window_edge": _window_edge_case,
               "short_rows": _short_rows_case}


def _pallas_seq(keys, queries):
    return np.asarray(PK._merge_rank_flags_impl(jnp.asarray(keys), jnp.asarray(queries),
                                                nb=8, impl="seq"))


def _hold(keys, queries, want=None):
    """The model against the plain version (bit for bit everywhere, padding
    flags included) and, given, efg_tpu's kernel (counts everywhere, flags
    at valid queries); no read outside [0, Vk)."""
    got, reads = rank_block_model(keys, queries)
    plain = K.rank_flags_plain(torch.from_numpy(keys), torch.from_numpy(queries)).numpy()
    np.testing.assert_array_equal(got, plain)
    if want is not None:
        np.testing.assert_array_equal(got >> 3, want >> 3)
        ok = queries < INVALID_Q
        np.testing.assert_array_equal(got[ok], want[ok])
    assert reads.low >= 0 and reads.top < max(len(keys), 1)
    return reads


@pytest.mark.parametrize("case", list(RANK_CASES) + list(EXTRA_CASES))
def test_rank_block_model_matches_pallas(case):
    """The model against efg_tpu's `_rank_kernel_seq` and the plain version
    on the rank kernels' hazard cases, on spans at the register window's
    edge and on spans too wide for it."""
    keys, queries = {**RANK_CASES, **EXTRA_CASES}[case]()
    reads = _hold(keys, queries, _pallas_seq(keys, queries))
    n_warps = -(-queries.size // RUN)
    assert reads.rounds <= n_warps * _max_rounds(len(keys))  # one warp search a warp
    if case == "sparse_rows":
        assert reads.windows == 0 and reads.wide == n_warps
    if case == "window_edge":  # the row of queries 1 apart takes the window, the others not
        assert reads.windows == 4 and reads.wide == 8


def test_rank_block_model_on_chip_smoke_cases():
    """chip_smoke.py's RANK_EDGE_CASES (with Vk = 2^20 + 3) through the
    model, against the plain version, bit for bit."""
    for name, make in _chip_smoke().RANK_EDGE_CASES.items():
        _hold(*make())


@pytest.mark.parametrize("kind", ["subm", "strided", "strided_311", "inverse"])
def test_rank_block_model_on_rulebooks(kind):
    """The model on the rank calls the port's rulebook builders make (SubM,
    a (3,3,3) stride-2 conv, the (3,1,1) stride-(2,1,1) conv, whose queries
    skip every other plane of keys, and a strided conv's inverse), captured
    from the builders, against efg_tpu's kernel and the plain version. On
    SubM the warps whose 128 queries stay in one row take the window."""
    feats, coords, valid, shape = sites(8, bsz=2, n=300, cap=320, c=16, shape=(8, 24, 24))
    _, st_t = both_tensors(feats, coords, valid, shape)
    calls, real = [], K.merge_rank_flags

    def spy(keys, queries, **kw):
        calls.append((keys.numpy().copy(), queries.numpy().copy()))
        return real(keys, queries, **kw)

    K.merge_rank_flags = spy
    try:
        if kind == "subm":
            K.build_monotone_rule9(st_t, 3)
        else:
            ks, stride, pad = (((3, 1, 1), (2, 1, 1), (0, 0, 0)) if kind == "strided_311"
                               else ((3, 3, 3), (2, 2, 2), (1, 1, 1)))
            out = TS.spconv_downsample(st_t, torch.zeros(int(np.prod(ks)), 16, 16),
                                       kernel_size=ks, stride=stride, padding=pad, max_out=200)
            if kind == "inverse":
                calls.clear()
                K.build_monotone_rule_strided_inverse(st_t, out.keys, out.spatial_shape, ks,
                                                      stride, pad)
    finally:
        K.merge_rank_flags = real
    assert calls
    for keys, queries in calls:
        reads = _hold(keys, queries, _pallas_seq(keys, queries))
        if kind == "subm":
            assert reads.windows > reads.wide


def test_model_follows_the_kernel_source():
    """The model's constants are those of csrc/rank_flags.cu."""
    src = (ROOT / "efg_tpu_torch" / "csrc" / "rank_flags.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kPerLane")) == PER_LANE and const("kRun") == "32 * kPerLane"
    assert int(const("kWindow")) == WINDOW and WINDOW & (WINDOW - 1) == 0
    assert int(const("kSlack")) == SLACK
    assert "l1 - l0 <= kWindow - 3" in src  # the window rule
    assert "warp_lower_bounds<3>(keys, tq, lb, ub, kSlack)" in src
    assert "rank_walk::warp_lower_bounds<3>" in src
