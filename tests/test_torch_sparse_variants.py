"""Port parity: the switches of the sparse kernels (EFG_RANK_IMPL,
`seq=False`, EFG_SPARSE_G3) in efg_tpu_torch against efg_tpu's.

On the CPU every variant runs the plain version, so the arithmetic each
Hopper variant adds is held here through what surrounds it: the seq4
kernel's block seeds and the hostwin kernel's key windows, computed by the
port's wrappers and walked by a numpy model of each kernel that reads only
the keys the kernel stages, against efg_tpu's Pallas kernels in interpret
mode; the g3 gate against the one efg_tpu applies, over every gather of the
trunk's forward and backward; the stacked layout of the group-merged grid.
The kernels themselves are held against the plain versions on the card by
chip_smoke.py (phase `variants`)."""

import functools

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


def _chunk_rank(chunk, q):
    """(count of chunk keys < q, q−1 ∈ chunk, q ∈ chunk, q+1 ∈ chunk) for a
    sorted chunk, as each kernel thread forms them in shared memory."""
    n = len(chunk)
    lo = np.searchsorted(chunk, q, side="left")
    at = lambda i: chunk[np.clip(i, 0, n - 1)]  # noqa: E731
    e = (lo < n) & (at(lo) == q)
    return (lo, (lo > 0) & (at(lo - 1) == q - 1), e, (lo + e < n) & (at(lo + e) == q + 1))


def _staged(keys, start, n):
    """Keys [start, start + n) clamped, CLAMP_Q past the end: what a block
    stages (it reads nothing at or past Vk)."""
    out = np.full(n, CLAMP_Q, np.int64)
    real = keys[start:start + n]
    out[:len(real)] = np.minimum(real, CLAMP_Q)
    return out


def _finish(q, cnt, fm, f0, fp, pad_count):
    valid = q < INVALID_Q
    flags = fm * 4 + f0 * 2 + fp
    return np.where(valid, cnt * 8 + flags, pad_count * 8)


def seq4_model(keys, queries):
    """rank_flags_seq4.cu in numpy: per block of SEQ4_QUERIES queries, the
    walk over 512-key chunks from the wrapper's seed and its stop rule.
    Returns (packed, chunks staged per block)."""
    seeds, n_below = K.seq4_seeds(torch.from_numpy(keys), torch.from_numpy(queries))
    seeds, n_below = seeds.numpy(), int(n_below[0])
    nq, ch = K.SEQ4_QUERIES, K.SEQ4_CHUNK
    n_chunks = -(-len(keys) // ch)
    out = np.zeros(queries.shape, np.int64)
    staged = np.zeros(seeds.shape, int)
    for p in range(queries.shape[0]):
        for b in range(seeds.shape[1]):
            q = queries[p, b * nq:(b + 1) * nq].astype(np.int64)
            valid = q < INVALID_Q
            cnt = np.full(q.shape, seeds[p, b] * ch, np.int64)
            fm = f0 = fp = np.zeros(q.shape, bool)
            if valid.any():
                qmax = q[valid].max()
                for r in range(seeds[p, b], n_chunks):
                    chunk = _staged(keys, r * ch, ch)
                    staged[p, b] += 1
                    lo, m, e, pl = _chunk_rank(chunk, q)
                    cnt, fm, f0, fp = cnt + lo, fm | m, f0 | e, fp | pl
                    if chunk[-1] >= qmax + 2 or chunk[-1] >= CLAMP_Q:
                        break
            out[p, b * nq:(b + 1) * nq] = _finish(q, cnt, fm, f0, fp, n_below)
    return out, staged


def hostwin_model(keys, queries, piece_rows=16):
    """rank_flags_hostwin.cu in numpy: per band of 128 queries, its window
    from the wrapper, staged in pieces of 16 rows, with the early stop at a
    piece ending in CLAMP_Q. Returns (packed, rows staged per band)."""
    wrow, nrows = (t.numpy() for t in K.hostwin_windows(torch.from_numpy(keys),
                                                         torch.from_numpy(queries)))
    row = K.HOSTWIN_ROW
    out = np.zeros(queries.shape, np.int64)
    staged = np.zeros(wrow.shape, int)
    for p in range(queries.shape[0]):
        for b in range(wrow.shape[1]):
            q = queries[p, b * row:(b + 1) * row].astype(np.int64)
            valid = q < INVALID_Q
            qc = np.where(valid, q, CLAMP_Q)
            has_pad = not valid.all()
            qmax = q[valid].max() if valid.any() else None
            cnt = np.full(q.shape, wrow[p, b] * row, np.int64)
            fm = f0 = fp = np.zeros(q.shape, bool)
            for r0 in range(0, nrows[p, b], piece_rows):
                rows = min(piece_rows, nrows[p, b] - r0)
                piece = _staged(keys, (wrow[p, b] + r0) * row, rows * row)
                staged[p, b] += rows
                lo, m, e, pl = _chunk_rank(piece, qc)
                cnt, fm, f0, fp = cnt + lo, fm | m, f0 | e, fp | pl
                if piece[-1] >= CLAMP_Q or (not has_pad and piece[-1] >= qmax + 2):
                    break
            # padding queries keep their window count (no flags)
            out[p, b * row:(b + 1) * row] = np.where(valid, _finish(q, cnt, fm, f0, fp, 0),
                                                     cnt * 8)
    return out, staged


def _padded_case():
    """3000 valid keys then 7000 padding keys (Vk = 10000: 20 chunks of 512
    keys, 79 key rows of 128); a row that ends in padding, a row of padding
    only, and a row of valid queries. Vq = 600 is a multiple of neither 256
    nor 128."""
    rs = np.random.RandomState(7)
    keys = np.sort(rs.choice(40000, 3000, replace=False)).astype(np.int32)
    keys = np.pad(keys, (0, 7000), constant_values=np.iinfo(np.int32).max)
    base = np.sort(rs.choice(42000, 600, replace=False)).astype(np.int32)
    tail = np.concatenate([base[:350], INVALID_Q + np.arange(250, dtype=np.int32)])
    queries = np.stack([tail, np.full(600, CLAMP_Q, np.int32), base + 3])
    return keys, queries


def _boundary_case(chunk):
    """The q−1 neighbour of a row's first query at an exact chunk boundary:
    keys 0..chunk−1 then padding, first query `chunk`."""
    keys = np.pad(np.arange(chunk, dtype=np.int32), (0, 64), constant_values=CLAMP_Q)
    return keys, (np.arange(64, dtype=np.int32) * 2 + chunk)[None]


RANK_CASES = {"rank_case": lambda: _rank_case(3), "boundary_512": lambda: _boundary_case(512),
              "boundary_128": lambda: _boundary_case(128), "padded": _padded_case}


@pytest.mark.parametrize("case", list(RANK_CASES))
@pytest.mark.parametrize("impl", ["seq4", "hostwin"])
def test_rank_variant_walk_matches_pallas(impl, case):
    """The numpy model of the Hopper kernel, on the wrapper's seeds or
    windows, against efg_tpu's kernel of the same name: counts exact
    everywhere, flags exact at valid queries. A block of padding only reads
    no chunk; no block stages the keys' padding tail."""
    keys, queries = RANK_CASES[case]()
    want = np.asarray(PK._merge_rank_flags_impl(jnp.asarray(keys), jnp.asarray(queries),
                                                nb=8, impl=impl))
    got, staged = (seq4_model if impl == "seq4" else hostwin_model)(keys, queries)
    np.testing.assert_array_equal(got >> 3, want >> 3)
    ok = queries < INVALID_Q
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_array_equal(got >> 3, K.rank_flags_plain(
        torch.from_numpy(keys), torch.from_numpy(queries)).numpy() >> 3)
    if case == "padded":  # the padding tail (14 chunks, 55 rows) is never walked
        if impl == "seq4":
            assert staged[1].max() == 0  # padding only: the count comes from n_below
            assert staged[0].max() <= 3  # stops at the first chunk ending in CLAMP_Q
        else:
            _, nrows = K.hostwin_windows(torch.from_numpy(keys), torch.from_numpy(queries))
            assert nrows.max() > 50  # a row's last band: its window reaches the last key row
            assert staged.max() <= 16  # one piece, then the stop at a CLAMP_Q row


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
