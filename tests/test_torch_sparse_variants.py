"""Port parity: the switches of the sparse kernels (EFG_RANK_IMPL,
`seq=False`, EFG_SPARSE_G3) in efg_tpu_torch against efg_tpu's.

On the CPU every variant runs the plain version, so the arithmetic each
Hopper variant adds is held here through numpy models of the kernels: the
seq4 and hostwin kernels' warp searches (their starts equal to the
formula `seq4_seeds` / `hostwin_windows` keeps) and their walk over the
pieces a directory names, reading only the keys the kernel reads, against
efg_tpu's Pallas kernels in interpret mode on hazard cases; the g3 gate
against the one efg_tpu applies, over every gather of the trunk's forward
and backward; the stacked layout of the group-merged grid. The kernels
themselves are held against the plain versions on the card by
chip_smoke.py (phase `variants`, with its copy of the hazard cases)."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops.pallas import sparse_kernels as PK
from efg_tpu_torch.modeling.backbones import sparse_net as TN
from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.ops.cuda import sparse_kernels as K

from test_torch_sparse_kernels import NO_LAUNCHES, _rank_case, both_tensors, sites

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PK.set_interpret(True)

INVALID_Q, CLAMP_Q = K.INVALID_Q, K.CLAMP_Q


@pytest.mark.parametrize("seq", [True, False])
@pytest.mark.parametrize("env", ["seq", "seq4", "hostwin", "merge"])
def test_rank_switch_resolves_as_jax(env, seq, monkeypatch):
    """The kernel a call runs, and the ValueError for an unknown value, as
    efg_tpu resolves them; `seq=False` is hostwin whatever the variable."""
    seen, real = [], PK._merge_rank_flags_impl

    def spy(keys, queries, *, nb, impl):
        seen.append(impl)  # trace only: an unknown impl raises while tracing
        return jax.eval_shape(functools.partial(real, nb=nb, impl=impl), keys, queries)

    monkeypatch.setattr(PK, "_RANK_IMPL", env)
    monkeypatch.setattr(K, "_RANK_IMPL", env)
    monkeypatch.setattr(PK, "_merge_rank_flags_impl", spy)
    keys, queries = _rank_case(3)
    try:
        PK.merge_rank_flags(jnp.asarray(keys), jnp.asarray(queries), seq=seq)
        want_err = None
    except ValueError as e:
        want_err = str(e)
    kt, qt = torch.from_numpy(keys), torch.from_numpy(queries)
    if want_err is not None:
        with pytest.raises(ValueError) as err:
            K.merge_rank_flags(kt, qt, seq=seq)
        assert str(err.value) == want_err
        return
    assert K.rank_impl(seq) == seen[0] == (env if seq else "hostwin")
    got = K.merge_rank_flags(kt, qt, seq=seq)
    assert torch.equal(got, K.rank_flags_plain(kt, qt))  # CPU: the plain version
    assert K.launches == NO_LAUNCHES


# rank_walk.cuh: warp lanes, keys per piece, pieces per directory, pieces staged at once
LANES, PIECE, DIR, SLOTS = 32, 512, 32, 4
SEQ4_SPEC, HOSTWIN_SPEC = 2, 1  # pieces each kernel stages while its first directory loads


def warp_lower_bound(kc, q):
    """rank_walk.cuh `warp_lower_bound` in numpy: lower_bound(q) over the
    clamped keys kc. The unknown keys are [lo, hi); each round the 32 lanes
    probe the last key of 32 segments of ⌈(hi − lo)/32⌉ keys, the ballot of
    "key < q" is a prefix of the lanes, and its length picks the segment.
    Returns (position, rounds, highest index read)."""
    lo, hi, rounds, top = 0, len(kc), 0, -1
    while hi > lo:
        step = -(-(hi - lo) // LANES)
        idx = lo + (np.arange(LANES) + 1) * step - 1
        on = idx < hi
        lt = np.zeros(LANES, bool)
        lt[on] = kc[idx[on]] < q
        c = int(lt.sum())
        assert lt[:c].all()  # the ballot is a prefix
        top = max(top, int(idx[on].max()))
        lo += c * step
        hi = min(lo + step - 1, hi)
        rounds += 1
    return lo, rounds, top


def _keys_at(kc, lim, p):
    """Clamped keys at positions p, CLAMP_Q at and past lim; (keys, the
    highest position read)."""
    p = np.asarray(p)
    read = p < lim
    out = np.full(p.shape, CLAMP_Q, np.int64)
    out[read] = kc[p[read]]
    return out, int(p[read].max()) if read.any() else -1


def _stage(kc, lim, base):
    """rank_walk.cuh's staging of one piece in numpy: keys [base, base +
    512) as 16-byte vectors; the vector that reaches lim (<= Vk) is read key
    by key, CLAMP_Q at and past lim. Returns (piece, highest index read)."""
    p = base + 4 * np.arange(PIECE // 4)
    idx = (p[:, None] + np.arange(4)).reshape(-1)
    vector = np.repeat(p + 4 <= lim, 4)
    read = vector | (idx < lim)  # a whole vector, or the keys of the last one below lim
    piece = np.full(PIECE, CLAMP_Q, np.int64)
    piece[read] = kc[idx[read]]
    return piece, int(idx[read].max()) if read.any() else -1


def _walk(kc, lim, begin, q, search, spec):
    """rank_walk.cuh `walk` in numpy: directories of 32 pieces of 512 keys
    from `begin` (their first and last keys), each searching query's piece
    (the first whose last key is >= q); the first `spec` pieces staged while
    the first directory loads, and, unless they hold every lower bound, the
    pieces that hold one staged after it; the probes across a piece's edge
    read from the directory. Returns ((count, fm, f0, fp) per query, pieces
    staged as the directory names them, directories, highest index
    read)."""
    cnt = np.zeros(q.shape, np.int64)
    fm, f0, fp = (np.zeros(q.shape, bool) for _ in range(3))
    open_, before = search.copy(), q.copy()  # before: the key ahead of this directory
    staged, dirs, top = 0, 0, -1
    slots = [None] * SLOTS
    base = begin
    while True:
        starts = base + PIECE * np.arange(DIR + 1)
        first, t1 = _keys_at(kc, lim, starts)
        last, t2 = _keys_at(kc, lim, starts[:DIR] + PIECE - 1)
        dirs, top = dirs + 1, max(top, t1, t2)
        if base == begin:  # the speculative pieces, slot j holding piece j
            for j in range(spec):
                slots[j], t = _stage(kc, lim, base + j * PIECE)
                top = max(top, t)
        c = np.where(open_ & (q <= last[-1]), np.searchsorted(last, q, side="left"), -1)
        need = np.unique(c[c >= 0])
        resident = base == begin and (need < spec).all()  # the staged pieces hold every one
        # (pieces, their slots): the resident pieces in their own slots, else
        # groups of up to SLOTS pieces, slot k taking the group's k-th piece
        groups = ([(need, need)] if resident else
                  [(need[g:g + SLOTS], range(len(need[g:g + SLOTS])))
                   for g in range(0, len(need), SLOTS)])
        for pieces, where in groups:
            if not resident:
                for k, j in zip(where, pieces):
                    slots[k], t = _stage(kc, lim, base + j * PIECE)
                    staged, top = staged + 1, max(top, t)
            for k, j in zip(where, pieces):
                piece, mine = slots[k], c == j
                lo = np.searchsorted(piece, q, side="left")
                assert (lo[mine] < PIECE).all()  # the piece's last key is >= q
                at = lambda i: piece[np.clip(i, 0, PIECE - 1)]  # noqa: E731, B023
                prev = np.where(lo > 0, at(lo - 1), last[j - 1] if j > 0 else before)
                e = at(lo) == q
                nxt = np.where(lo + e < PIECE, at(lo + e), first[j + 1])
                cnt = np.where(mine, base + j * PIECE + lo, cnt)
                fm, f0, fp = (np.where(mine, v, old) for v, old in
                              ((prev == q - 1, fm), (e, f0), (nxt == q + 1, fp)))
        open_ &= c < 0
        before = np.full(q.shape, last[-1])
        if not open_.any():
            return (cnt, fm, f0, fp), staged, dirs, top
        base += DIR * PIECE


def _block_stats(shape):
    """Per block: its start (seed or window row), pieces staged as its
    directories name them, directories loaded, warp-search rounds, the
    highest key index read (−1: none) and the pieces that hold some
    searching query's lower bound."""
    return {k: np.full(shape, -1, np.int64)
            for k in ("start", "staged", "dirs", "rounds", "top", "lb_pieces")}


def _lb_pieces(kc, begin, q):
    """How many 512-key pieces from `begin` hold the lower bound of some q."""
    return len(np.unique((np.searchsorted(kc, q, side="left") - begin) // PIECE)) if len(q) else 0


def seq4_model(keys, queries):
    """rank_flags_seq4.cu in numpy, block by block (SEQ4_QUERIES queries of
    a row): the warp search for the lower bound of the block's first query,
    the seed (lower bound − 1) / 512, the padding count from a warp search
    for CLAMP_Q, and the walk from the seed. Returns (packed, per-block
    stats, n_below)."""
    kc = np.minimum(keys.astype(np.int64), CLAMP_Q)
    nq, (n_rows, vq) = K.SEQ4_QUERIES, queries.shape
    out = np.zeros(queries.shape, np.int64)
    stats = _block_stats((n_rows, -(-vq // nq)))
    n_below = None
    for p in range(n_rows):
        for b in range(stats["start"].shape[1]):
            q = queries[p, b * nq:(b + 1) * nq].astype(np.int64)
            valid = q < INVALID_Q
            lb, rounds, top = warp_lower_bound(kc, q[0]) if valid[0] else (0, 0, -1)
            seed = max(lb - 1, 0) // PIECE
            below = 0
            if not valid.all():  # each warp that holds a padding query
                below, r2, t2 = warp_lower_bound(kc, CLAMP_Q)
                n_below, rounds, top = below, max(rounds, r2), max(top, t2)
            (cnt, fm, f0, fp), staged, dirs = (0, 0, 0, 0), 0, 0
            if valid.any():
                (cnt, fm, f0, fp), staged, dirs, t3 = _walk(kc, len(keys), seed * PIECE, q, valid,
                                                             SEQ4_SPEC)
                top = max(top, t3)
            out[p, b * nq:(b + 1) * nq] = np.where(valid, cnt * 8 + fm * 4 + f0 * 2 + fp,
                                                    below * 8)
            for k, v in zip(stats, (seed, staged, dirs, rounds, top,
                                    _lb_pieces(kc, seed * PIECE, q[valid]))):
                stats[k][p, b] = v
    return out, stats, n_below


def hostwin_model(keys, queries):
    """rank_flags_hostwin.cu in numpy, band by band (HOSTWIN_ROW queries of
    a row): the warp searches for the lower bounds of the band's first query
    and of the next band's, the window from them, and the walk over the
    window's keys. Returns (packed, per-band stats with "nrows")."""
    kc = np.minimum(keys.astype(np.int64), CLAMP_Q)
    row, (n_rows, vq) = K.HOSTWIN_ROW, queries.shape
    kr = -(-len(keys) // row)
    qc_all = np.where(queries < INVALID_Q, queries.astype(np.int64), CLAMP_Q)
    out = np.zeros(queries.shape, np.int64)
    stats = _block_stats((n_rows, -(-vq // row)))
    stats["nrows"] = np.full_like(stats["start"], -1)
    for p in range(n_rows):
        for b in range(stats["start"].shape[1]):
            valid = queries[p, b * row:(b + 1) * row] < INVALID_Q
            qc = qc_all[p, b * row:(b + 1) * row]
            lb, rounds, top = warp_lower_bound(kc, qc[0])
            last = kr - 1
            if b + 1 < stats["start"].shape[1]:  # the next band's start
                lb1, r1, t1 = warp_lower_bound(kc, qc_all[p, (b + 1) * row])
                last, rounds, top = min((lb1 + 1) // row, kr - 1), max(rounds, r1), max(top, t1)
            wrow = max(lb - 1, 0) // row
            nrows = max(last - wrow + 1, 1)
            lim = min(len(keys), (wrow + nrows) * row)
            (cnt, fm, f0, fp), staged, dirs, t3 = _walk(kc, lim, wrow * row, qc,
                                                         np.ones(qc.shape, bool), HOSTWIN_SPEC)
            out[p, b * row:(b + 1) * row] = cnt * 8 + np.where(valid, fm * 4 + f0 * 2 + fp, 0)
            for k, v in zip(stats, (wrow, staged, dirs, rounds, max(top, t3),
                                    _lb_pieces(kc, wrow * row, qc), nrows)):
                stats[k][p, b] = v
    return out, stats


I32_MAX = np.iinfo(np.int32).max


def _padded_case():
    """3000 valid keys then 7000 padding keys (Vk = 10000: 20 chunks of 512
    keys, 79 key rows of 128); a row that ends in padding, a row of padding
    only, and a row of valid queries. Vq = 600 is a multiple of neither 256
    nor 128."""
    rs = np.random.RandomState(7)
    keys = np.sort(rs.choice(40000, 3000, replace=False)).astype(np.int32)
    keys = np.pad(keys, (0, 7000), constant_values=I32_MAX)
    base = np.sort(rs.choice(42000, 600, replace=False)).astype(np.int32)
    tail = np.concatenate([base[:350], INVALID_Q + np.arange(250, dtype=np.int32)])
    queries = np.stack([tail, np.full(600, CLAMP_Q, np.int32), base + 3])
    return keys, queries


def _boundary_case(chunk):
    """The q−1 neighbour of a row's first query at an exact chunk boundary:
    keys 0..chunk−1 then padding, first query `chunk`."""
    keys = np.pad(np.arange(chunk, dtype=np.int32), (0, 64), constant_values=CLAMP_Q)
    return keys, (np.arange(64, dtype=np.int32) * 2 + chunk)[None]


def _vk1_case():
    """Vk = 1: queries below, beside, at and above the one key, then
    padding; and a row of padding only."""
    row = np.array([-9, 0, 5, 6, 7, 8, 9, 40, INVALID_Q, CLAMP_Q], np.int32)
    return np.array([7], np.int32), np.stack([row, row + 1, np.full(10, INVALID_Q, np.int32)])


def _vk_mod4_case():
    """Vk = 1027, all keys valid: the last 16-byte vector reaches past Vk.
    The queries run below the first key and past the last one."""
    rs = np.random.RandomState(11)
    keys = np.sort(rs.choice(3000, 1027, replace=False)).astype(np.int32)
    base = np.sort(rs.choice(np.arange(-40, 3100), 700, replace=False)).astype(np.int32)
    return keys, np.stack([base, base + 1, base + 2999])


def _all_padding_case():
    """Every key is padding (Vk = 203): three in [INVALID_Q, CLAMP_Q), then
    CLAMP_Q and int32 max. Valid queries count 0; padding queries count the
    three."""
    keys = np.concatenate([INVALID_Q + np.array([0, 5, 9]), np.full(100, CLAMP_Q),
                           np.full(100, I32_MAX)]).astype(np.int32)
    valid = np.arange(0, 600, 2)
    return keys, np.stack([valid, np.concatenate([valid[:200], INVALID_Q + np.arange(100)])]
                          ).astype(np.int32)


def _invalid_keys_case():
    """30 keys in [INVALID_Q, CLAMP_Q) between 900 valid keys and a CLAMP_Q
    tail (Vk = 1030): padding queries count them, valid ones do not."""
    rs = np.random.RandomState(12)
    keys = np.concatenate([np.sort(rs.choice(20000, 900, replace=False)),
                           INVALID_Q + np.sort(rs.choice(1000, 30, replace=False)),
                           np.full(100, CLAMP_Q)]).astype(np.int32)
    base = np.sort(rs.choice(21000, 800, replace=False))
    return keys, np.stack([base, np.concatenate([base[:500], INVALID_Q + np.arange(300)]),
                           np.concatenate([base[:64], np.full(736, CLAMP_Q)])]).astype(np.int32)


def _outside_case():
    """Keys in [10000, 20000) then padding; rows of queries below the first
    key (some negative), above the last, and both."""
    rs = np.random.RandomState(13)
    keys = np.pad(np.sort(rs.choice(np.arange(10000, 20000), 1000, replace=False)), (0, 24),
                  constant_values=CLAMP_Q).astype(np.int32)
    below = np.sort(rs.choice(np.arange(-50000, 10000), 300, replace=False))
    above = np.sort(rs.choice(np.arange(20000, 400000), 300, replace=False))
    mixed = np.sort(np.concatenate([below[::2], above[::2]]))
    return keys, np.stack([below, above, mixed]).astype(np.int32)


def _long_case():
    """Vk = 40001, past 2^15, with a padding tail; rows of 1500 queries whose
    blocks span a dozen 512-key pieces, and a row of 300 sparser ones whose
    blocks span more than one directory (32 pieces)."""
    rs = np.random.RandomState(14)
    keys = np.pad(np.sort(rs.choice(200000, 39000, replace=False)), (0, 1001),
                  constant_values=I32_MAX).astype(np.int32)
    base = np.sort(rs.choice(200000, 1500, replace=False))
    return keys, np.stack([base, np.concatenate([base[:1200] + 1, INVALID_Q + np.arange(300)]),
                           np.concatenate([base[::5], np.full(1200, CLAMP_Q)])]).astype(np.int32)


RANK_CASES = {"rank_case": lambda: _rank_case(3), "boundary_512": lambda: _boundary_case(512),
              "boundary_128": lambda: _boundary_case(128), "padded": _padded_case,
              "vk1": _vk1_case, "vk_mod4": _vk_mod4_case, "all_padding": _all_padding_case,
              "invalid_keys": _invalid_keys_case, "outside": _outside_case, "long": _long_case}


def _max_rounds(vk):
    """The most rounds the warp search takes over Vk keys: a round leaves at
    most ⌈n/32⌉ − 1 of n unknown keys, so k rounds resolve up to N_k keys,
    N_k = 32·(N_{k−1} + 1): 32, 1056, 33 824, 1 082 400."""
    k, n = 0, 0
    while n < vk:
        k, n = k + 1, LANES * (n + 1)
    return k


@pytest.mark.parametrize("case", list(RANK_CASES))
@pytest.mark.parametrize("impl", ["seq4", "hostwin"])
def test_rank_variant_walk_matches_pallas(impl, case):
    """The numpy model of the Hopper kernel (its warp searches and its walk
    over the pieces its directory names) against efg_tpu's kernel of the
    same name: counts exact everywhere, flags exact at valid queries. The
    starts the blocks find are the TPU wrapper's formula (`seq4_seeds`,
    `hostwin_windows`); no block reads at or past Vk or stages a piece that
    holds no lower bound; a block of padding only stages nothing."""
    keys, queries = RANK_CASES[case]()
    want = np.asarray(PK._merge_rank_flags_impl(jnp.asarray(keys), jnp.asarray(queries),
                                                nb=8, impl=impl))
    kt, qt = torch.from_numpy(keys), torch.from_numpy(queries)
    if impl == "seq4":
        got, stats, n_below = seq4_model(keys, queries)
        seeds, below = K.seq4_seeds(kt, qt)
        walks = queries[:, ::K.SEQ4_QUERIES] < INVALID_Q  # a padding block walks nothing
        np.testing.assert_array_equal(stats["start"][walks], seeds.numpy()[walks])
        assert n_below in (None, int(below[0]))
    else:
        got, stats = hostwin_model(keys, queries)
        wrow, nrows = K.hostwin_windows(kt, qt)
        np.testing.assert_array_equal(stats["start"], wrow.numpy())
        np.testing.assert_array_equal(stats["nrows"], nrows.numpy())
    np.testing.assert_array_equal(got >> 3, want >> 3)
    ok = queries < INVALID_Q
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_array_equal(got >> 3, K.rank_flags_plain(kt, qt).numpy() >> 3)
    vk = len(keys)
    assert stats["top"].max() < vk
    assert stats["rounds"].max() <= _max_rounds(vk)
    # beyond the speculative pieces, only pieces that hold a lower bound are
    # staged; a block of padding only stages nothing
    assert (stats["staged"] <= np.maximum(stats["lb_pieces"], 0)).all()
    if case == "padded":
        if impl == "seq4":
            assert stats["dirs"][1].max() == 0  # padding only: the count is n_below
        else:  # a row's last band: its window reaches the last key row, one piece holds it
            assert stats["nrows"][:, -1].min() > 50 and stats["lb_pieces"][:, -1].max() == 1
            assert stats["staged"][:, -1].max() == 0  # that piece is the speculative one
    if case == "long":  # blocks that stage more than one group of 4 pieces, and span directories
        assert stats["staged"].max() > 4 and stats["dirs"].max() >= 2


@pytest.mark.parametrize("vk", [1, 32, 33, 1056, 40001, (1 << 20) + 3])
def test_warp_search_is_lower_bound(vk):
    """The warp search of both kernels against searchsorted over sorted keys
    with a padding tail: keys below, at, between and above, CLAMP_Q and
    beyond; no read at or past Vk, and at most `_max_rounds` rounds (4 up
    to 1 082 400 keys)."""
    rs = np.random.RandomState(vk % 1000)
    n_pad = vk // 7
    kc = np.sort(rs.choice(4 * vk + 8, vk - n_pad, replace=False)).astype(np.int64)
    kc = np.concatenate([kc, np.full(n_pad, CLAMP_Q)])
    qs = np.concatenate([[-5, 0, CLAMP_Q, CLAMP_Q + 1], kc[rs.randint(0, vk, 40)],
                         rs.randint(-10, 4 * vk + 20, 40)])
    for q in qs:
        lb, rounds, top = warp_lower_bound(kc, q)
        assert lb == np.searchsorted(kc, q, side="left")
        assert rounds <= _max_rounds(vk) and top < vk
    assert _max_rounds(vk) == {1: 1, 32: 1, 33: 2, 1056: 2, 40001: 4, (1 << 20) + 3: 4}[vk]


def test_chip_smoke_cases_are_these():
    """chip_smoke.py's own copy of the hazard cases, which it runs through
    the three rank kernels on the card, makes the same arrays as these."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    shared = set(cs.RANK_EDGE_CASES) & set(RANK_CASES)
    assert shared == set(RANK_CASES) - {"rank_case"}
    for name in shared:
        for a, b in zip(cs.RANK_EDGE_CASES[name](), RANK_CASES[name]()):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert cs.RANK_EDGE_CASES["vk_2e20"]()[0].shape == ((1 << 20) + 3,)


GRID = (32, 32, 40)  # (nx, ny, nz): the trunk at test_torch_sparse_net's size


def _trunk(rank_impl: str, g3: bool):
    """The port's full-width trunk (its 21 convs) forward and backward on
    the CPU under the switches; returns the BEV, the gradients, the (C, P)
    of every forward and every stacked gather, and the launch counts."""
    feats, coords, valid, _ = sites(3, bsz=2, n=300, cap=320, c=5, shape=(41, 32, 32))
    torch.manual_seed(0)
    tm = TN.SpMiddleResNetFHD(num_input_features=5, grid_size=GRID,
                              stage_caps=(320, 320, 320, 320), act_dtype="bfloat16")
    calls = {"forward": [], "stacked": [], "rulebooks": []}
    fwd0, st0, rank0 = K.fused_gather_gemm, K.gather_gemm_stacked, K.merge_rank_flags

    def fwd(f, packed, w):
        calls["forward"].append((f.shape[1], packed.shape[0]))
        return fwd0(f, packed, w)

    def stacked(f, packed, w):
        calls["stacked"].append((f.shape[1], packed.shape[0]))
        return st0(f, packed, w)

    def rank(keys, queries, **kw):
        out = rank0(keys, queries, **kw)
        calls["rulebooks"].append(out)
        return out

    saved = (K._RANK_IMPL, K._G3)
    K._RANK_IMPL, K._G3 = rank_impl, g3
    K.fused_gather_gemm, K.gather_gemm_stacked, K.merge_rank_flags = fwd, stacked, rank
    K.reset_launches()
    try:
        f = torch.from_numpy(feats).requires_grad_()
        bev = tm(f, torch.from_numpy(coords), torch.from_numpy(valid))
        bev.float().square().sum().backward()
    finally:
        K._RANK_IMPL, K._G3 = saved
        K.fused_gather_gemm, K.gather_gemm_stacked, K.merge_rank_flags = fwd0, st0, rank0
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    return bev.detach(), grads, calls, dict(K.launches)


@pytest.fixture(scope="module")
def trunk_runs():
    return _trunk("seq", False), _trunk("seq4", True)


def _jax_takes_g3(cin: int, n_pairs: int, emit: bool) -> bool:
    """Which Pallas kernel efg_tpu's fused_gather_gemm traces for a gather
    of this width and pair count, with EFG_SPARSE_G3 set (traced, not run)."""
    seen = []
    spies = {name: getattr(PK, name) for name in ("_fwd_kernel", "_fwd_kernel_g3")}

    def spy(name):
        def kern(*a, **kw):
            seen.append(name)
            return spies[name](*a, **kw)
        return kern

    old = PK._G3
    try:
        PK._G3 = True
        for name in spies:
            setattr(PK, name, spy(name))
        PK.fused_gather_gemm.clear_cache()  # _G3 and the kernels are read at trace time
        jax.eval_shape(functools.partial(PK.fused_gather_gemm, tile=128, emit_stacked=emit),
                       jax.ShapeDtypeStruct((64, cin), jnp.float32),
                       jax.ShapeDtypeStruct((n_pairs, 64), jnp.int32),
                       jax.ShapeDtypeStruct((n_pairs * 3 * cin, 16), jnp.float32))
    finally:
        PK._G3 = old
        for name, fn in spies.items():
            setattr(PK, name, fn)
        PK.fused_gather_gemm.clear_cache()
    assert len(set(seen)) == 1
    return seen[0] == "_fwd_kernel_g3"


def test_g3_gate_matches_jax_over_the_trunk(trunk_runs, monkeypatch):
    """`use_g3` against efg_tpu's own choice for every (C, P) the trunk's 21
    forward gathers and 21 stacked (backward) gathers take: with the switch
    set it admits 16 and 15 of them, as on the flagship; unset, none."""
    _, _, calls, _ = trunk_runs[0]
    assert len(calls["forward"]) == len(calls["stacked"]) == 21
    for kind in ("forward", "stacked"):
        for c, p in set(calls[kind]):
            monkeypatch.setattr(K, "_G3", True)
            assert K.use_g3(c, p) == _jax_takes_g3(c, p, kind == "stacked"), (kind, c, p)
            monkeypatch.setattr(K, "_G3", False)
            assert not K.use_g3(c, p)
    monkeypatch.setattr(K, "_G3", True)
    assert sum(K.use_g3(c, p) for c, p in calls["forward"]) == 16
    assert sum(K.use_g3(c, p) for c, p in calls["stacked"]) == 15
    assert (32, 18) in calls["stacked"] and (64, 18) in calls["stacked"]  # down1/2 inverses


def test_switches_on_the_cpu_change_nothing(trunk_runs):
    """Under EFG_RANK_IMPL=seq4 and EFG_SPARSE_G3 the CPU runs the same plain
    versions: no launch, the same rulebooks, BEV and gradients bit for bit."""
    (bev0, g0, c0, l0), (bev1, g1, c1, l1) = trunk_runs
    assert l0 == l1 == {k: 0 for k in K.launches}
    assert len(c0["rulebooks"]) == len(c1["rulebooks"]) == 12  # 8 forward + 4 inverse
    for a, b in zip(c0["rulebooks"], c1["rulebooks"]):
        assert torch.equal(a, b)
    assert torch.equal(bev0, bev1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[n], g1[n]) for n in g0)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()) + 1e-6)


@pytest.mark.parametrize("kind", ["subm", "strided_inverse"])
def test_stacked_plain_matches_pallas_g3(kind, monkeypatch):
    """The stacked plain version against efg_tpu's group-merged grid with
    `emit_stacked=True` (its buffer transposed): a SubM rulebook (three
    δz-groups, C = 16) and a strided conv's inverse rulebook (six groups,
    the output gradient of width 32 gathered). Taps bit for bit, out at
    1e-4·max|ref| (summation order)."""
    monkeypatch.setattr(PK, "_G3", True)
    PK.fused_gather_gemm.clear_cache()
    rs = np.random.RandomState(21)
    feats, coords, valid, shape = sites(22, c=16)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    if kind == "subm":
        packed = K.build_monotone_rule9(st_t, 3)
        src = st_t.features.numpy()
    else:
        ks, stride, pad = (3, 3, 3), (2, 2, 2), (1, 1, 1)
        out = TS.spconv_downsample(st_t, torch.zeros(27, 16, 32), kernel_size=ks, stride=stride,
                                   padding=pad, max_out=96)
        packed, _ = K.build_monotone_rule_strided_inverse(st_t, out.keys, out.spatial_shape, ks,
                                                          stride, pad)
        src = rs.randn(96, 32).astype(np.float32)
    n_pairs, c = packed.shape[0], src.shape[1]
    assert n_pairs == (9 if kind == "subm" else 18)
    w = (rs.randn(n_pairs * 3 * c, 16) * 0.1).astype(np.float32)
    try:
        want_out, want_st = PK.fused_gather_gemm(jnp.asarray(src), jnp.asarray(packed.numpy()),
                                                 jnp.asarray(w), tile=128, emit_stacked=True)
    finally:
        PK.fused_gather_gemm.clear_cache()
    got_out, got_st = K.gather_gemm_stacked(torch.from_numpy(src), packed, torch.from_numpy(w))
    v = packed.shape[1]
    assert got_st.shape == (v, n_pairs * 3 * c)
    np.testing.assert_array_equal(got_st.float().numpy().T, np.asarray(want_st[:, :v], np.float32))
    _close(got_out, want_out)
    assert (packed.numpy() & 7).any() and K.launches == NO_LAUNCHES
