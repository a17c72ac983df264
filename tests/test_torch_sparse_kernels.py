"""Port parity: the sparse-conv kernels' plain versions and the packed
rulebook builders (efg_tpu_torch.ops.cuda.sparse_kernels) against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs.

On the CPU every wrapper runs its plain PyTorch version; the CUDA kernels
are held against those plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops import sparse as S
from efg_tpu.ops.pallas import sparse_kernels as PK
from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.ops.cuda import sparse_kernels as K

PK.set_interpret(True)

SHAPE = (6, 10, 12)  # (D, H, W)
NO_LAUNCHES = {"rank_flags": 0, "gather_gemm": 0, "gather_gemm_stacked": 0, "gather_dw": 0}


def sites(seed, bsz=2, n=60, cap=80, c=5, shape=SHAPE):
    """Per-sample voxelizer-style inputs: unique sites sorted by key."""
    rs = np.random.RandomState(seed)
    d, h, w = shape
    feats = np.zeros((bsz, cap, c), np.float32)
    coords = np.zeros((bsz, cap, 3), np.int32)
    valid = np.zeros((bsz, cap), bool)
    for b in range(bsz):
        lin = np.sort(rs.choice(d * h * w, size=n, replace=False))
        coords[b, :n] = np.stack([lin // (h * w), (lin // w) % h, lin % w], -1)
        feats[b, :n] = rs.randn(n, c)
        valid[b, :n] = True
    return feats, coords, valid, shape


def both_tensors(feats, coords, valid, shape):
    """The same sparse tensor in both packages."""
    st_j = S.from_batched_voxels(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), shape)
    st_t = TS.from_batched_voxels(torch.from_numpy(feats), torch.from_numpy(coords),
                                  torch.from_numpy(valid), shape)
    return st_j, st_t


def _rank_case(seed):
    rs = np.random.RandomState(seed)
    n = 700
    keys = np.unique(rs.randint(0, 5000, n).astype(np.int32))
    keys = np.pad(keys, (0, n - len(keys)), constant_values=np.iinfo(np.int32).max)
    # strictly-increasing valid queries per row, then padding (the contract)
    base = np.sort(rs.choice(6000, 600, replace=False)).astype(np.int32)
    queries = np.stack([base, base + 37, np.minimum(base + 1111, PK._CLAMP_Q), base - 251])
    return keys, queries


@pytest.mark.parametrize("impl,chunk", [("seq", 128), ("seq4", 512), ("hostwin", 128)])
def test_rank_flags_plain_matches_pallas(impl, chunk):
    """Counts exact everywhere, flags exact at valid queries (flags at
    padding queries are garbage by contract)."""
    keys, queries = _rank_case(3)
    # the q−1 neighbour of a row's FIRST query at an exact chunk boundary:
    # keys 0..chunk-1, first query `chunk`
    bkeys = np.pad(np.arange(chunk, dtype=np.int32), (0, 64), constant_values=PK._CLAMP_Q)
    bqueries = (np.arange(64, dtype=np.int32) * 2 + chunk)[None]
    for k, q in ((keys, queries), (bkeys, bqueries)):
        want = np.asarray(PK._merge_rank_flags_impl(jnp.asarray(k), jnp.asarray(q), nb=8, impl=impl))
        got = K.merge_rank_flags(torch.from_numpy(k), torch.from_numpy(q)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got >> 3, want >> 3)
        ok = q < PK.INVALID_Q
        np.testing.assert_array_equal(got[ok], want[ok])
    assert K.launches == NO_LAUNCHES  # CPU: plain version


def test_rule9_builder_matches_pallas():
    st_j, st_t = both_tensors(*sites(0))
    want = np.asarray(PK.build_monotone_rule9(st_j, 3))
    got = K.build_monotone_rule9(st_t, 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "ks,stride,pad",
    [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
     ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
     ((3, 1, 1), (2, 1, 1), (0, 0, 0))],
)
def test_strided_builder_matches_pallas(ks, stride, pad):
    """Equal int32 rulebooks, on output sites taken from the JAX conv."""
    st_j, st_t = both_tensors(*sites(1))
    out = S.spconv_downsample(st_j, jnp.zeros((int(np.prod(ks)), 5, 4)), kernel_size=ks,
                              stride=stride, padding=pad, max_out=96)
    c = np.array(out.coords)
    v = np.array(out.valid)
    want = np.asarray(PK.build_monotone_rule_strided(
        st_j, *(jnp.asarray(c[:, i]) for i in range(4)), jnp.asarray(v), ks, stride, pad))
    got = K.build_monotone_rule_strided(
        st_t, *(torch.from_numpy(c[:, i]) for i in range(4)), torch.from_numpy(v),
        ks, stride, pad).numpy()
    assert got.shape == want.shape == (9, 96)
    np.testing.assert_array_equal(got, want)


def _weights(seed, k, cin, cout):
    return np.random.RandomState(seed).randn(k, cin, cout).astype(np.float32) * 0.1


# Tolerances: against the Pallas kernel both sides round the same inputs to
# bf16 and accumulate exact products in f32, so only summation order
# differs (1e-4). Against the f32 XLA gather_gemm9 oracle the port's bf16
# rounding of features and weights shows (2e-2, as tests/test_pallas_sparse.py).
# tile=128 keeps the interpret-mode Pallas trace small (one band per step).
@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 32)])
def test_subm_gather_gemm_matches_pallas(cin, cout):
    feats, coords, valid, shape = sites(2, c=cin)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    w = _weights(3, 27, cin, cout)
    packed = K.build_monotone_rule9(st_t, 3)
    got = K.subm_conv9(st_t.features, packed, torch.from_numpy(w), st_t.valid).numpy()
    cin16 = -(-cin // 16) * 16  # subm_conv9 pads channels to a multiple of 16
    f16 = jnp.pad(st_j.features, ((0, 0), (0, cin16 - cin)))
    w16 = jnp.pad(jnp.asarray(w), ((0, 0), (0, cin16 - cin), (0, 0))).reshape(27 * cin16, cout)
    want = np.asarray(PK.fused_gather_gemm(f16, jnp.asarray(packed.numpy()), w16, tile=128))
    want = want * valid_rows(st_j)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    S.set_compute_dtype(jnp.float32)
    try:
        pos9, found9 = S.build_subm_rulebook9(st_j, 3)
        oracle = np.asarray(S.gather_gemm9(st_j.features, pos9, found9, jnp.asarray(w), st_j.valid))
    finally:
        S.set_compute_dtype(jnp.bfloat16)
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-2)
    assert K.launches == NO_LAUNCHES


def valid_rows(st_j):
    return np.asarray(st_j.valid)[:, None].astype(np.float32)


@pytest.mark.parametrize("ks,stride,pad", [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
                                           ((3, 1, 1), (2, 1, 1), (0, 0, 0))])
def test_strided_gather_gemm_matches_pallas(ks, stride, pad):
    """V_in ≠ V_out. The (3,1,1) conv runs whole through efg_tpu's Pallas
    spconv_downsample (kw=1 middle-tap weights over the ×3 dummy-pair
    rulebook on both sides); the (3,3,3) conv feeds the port's rulebook to
    the Pallas kernel (tile 128, a small interpret-mode trace)."""
    feats, coords, valid, shape = sites(4, c=16)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    k = int(np.prod(ks))
    w = _weights(5, k, 16, 16)
    got = TS.spconv_downsample(st_t, torch.from_numpy(w), kernel_size=ks, stride=stride,
                               padding=pad, max_out=96)
    if ks[1] == 1:
        out = S.spconv_downsample(st_j, jnp.asarray(w), kernel_size=ks, stride=stride,
                                  padding=pad, max_out=96, backend="pallas")
        np.testing.assert_array_equal(got.keys.numpy(), np.asarray(out.keys))
        want = np.asarray(out.features)
    else:
        c = got.coords
        packed = K.build_monotone_rule_strided(st_t, c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                                               got.valid, ks, stride, pad)
        want = np.asarray(PK.fused_gather_gemm(st_j.features, jnp.asarray(packed.numpy()),
                                               jnp.asarray(w.reshape(k * 16, 16)), tile=128))
        want = want * got.valid.numpy()[:, None]
    np.testing.assert_allclose(got.features.numpy(), want, rtol=1e-4, atol=1e-4)


def test_gather_gemm_plain_matches_g3_grid(monkeypatch):
    """The group-merged Pallas grid (`_fwd_kernel_g3`) computes the same
    function; the plain version agrees with it."""
    feats, coords, valid, shape = sites(5, c=16)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    w = _weights(6, 27, 16, 16).reshape(27 * 16, 16)
    packed = K.build_monotone_rule9(st_t, 3)
    monkeypatch.setattr(PK, "_G3", True)
    PK.fused_gather_gemm.clear_cache()  # _G3 is read at trace time: retrace
    want = np.asarray(PK.fused_gather_gemm(st_j.features, jnp.asarray(packed.numpy()),
                                           jnp.asarray(w), tile=128))
    PK.fused_gather_gemm.clear_cache()
    got = K.fused_gather_gemm(st_t.features, packed, torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
