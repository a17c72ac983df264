"""Port parity: the sparse convs' backward (efg_tpu_torch vs efg_tpu).

`torch.autograd` of the port's `subm_conv9` and strided conv against
`jax.vjp` of the JAX Pallas ops in interpret mode, the strided inverse
rulebook bit for bit, and the plain versions of the stacked gather-GEMM
and the dW kernel against the Pallas kernels (`emit_stacked=True`,
`fused_gather_dw`), all on the same numpy inputs.

Tolerance of every float comparison: 1e-4 · max|ref| (plus 1e-6). Both
packages round the same inputs to bf16 (the gradient too, before its
gather), form exact products and sum them in f32; only the summation order
differs. Rules are prepped with tile 128 on the JAX side, which keeps the
interpret-mode traces small."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.ops import sparse as S
from efg_tpu.ops.pallas import sparse_kernels as PK
from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.ops.cuda import sparse_kernels as K

from test_torch_sparse_kernels import NO_LAUNCHES, both_tensors, sites

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PK.set_interpret(True)

GEOMETRIES = [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
              ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
              ((3, 1, 1), (2, 1, 1), (0, 0, 0))]


def close(got, want, what):
    want = np.asarray(want, np.float32)
    tol = 1e-4 * float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol, err_msg=what)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _torch_vjp(fn, feats, w, g):
    f = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(f, wt)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), f.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("cin,cout", [(5, 16), (32, 32), (16, 8)])
def test_subm_vjp_matches_pallas(cin, cout):
    """cin 5 pads to 16 (the padded rows get no gradient); cout 8 is not a
    multiple of 16, so both packages take dW from the dW kernel."""
    feats, coords, valid, shape = sites(10, c=cin)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    w = _rand(11, 27, cin, cout, scale=0.1)
    g = _rand(12, st_t.features.shape[0], cout)
    packed = K.build_monotone_rule9(st_t, 3)
    cin16 = -(-cin // 16) * 16
    rule = PK.prep_rulebook(jnp.asarray(packed.numpy()), packed.shape[1], cin16, tile=128)
    want_out, vjp = jax.vjp(lambda f, wj: PK.subm_conv9(f, rule, wj, st_j.valid),
                            st_j.features, jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(g))
    got_out, got_df, got_dw = _torch_vjp(
        lambda f, wt: K.subm_conv9(f, packed, wt, st_t.valid), st_t.features.numpy(), w, g)
    close(got_out, want_out, "out")
    close(got_df, want_df, "d_features")
    close(got_dw, want_dw, "dW")
    assert got_df.shape == (packed.shape[1], cin) and got_dw.shape == (27, cin, cout)
    assert K.launches == NO_LAUNCHES  # CPU tensors: plain versions only


def _jax_strided(st_j, out_keys, out_coords, out_valid, out_shape, ks, stride, pad, cin, cout):
    """efg_tpu's Pallas strided conv as `spconv_downsample` sets it up, with
    both rulebooks prepped at tile 128."""
    kd, kh, kw = ks
    packed_raw = PK.build_monotone_rule_strided(
        st_j, *(out_coords[:, i] for i in range(4)), out_valid, ks, stride, pad)
    inv_raw, wmap = PK.build_monotone_rule_strided_inverse(st_j, out_keys, out_shape, ks,
                                                           stride, pad)
    v_in, v_out = st_j.capacity, out_keys.shape[0]
    ratio = max(1, -(-v_in // v_out))
    band = -(-(128 * ratio + 64) // 16) * 16
    wslack = 128 * (ratio - 1) + 2 * band + 256
    packed = PK.prep_rulebook(packed_raw, v_in, cin, tile=128, band=band, wslack=wslack)
    inv = (PK.prep_rulebook(inv_raw, v_out, cout, tile=128), wmap)

    def conv(f, w):
        if kh == 1:
            w = jnp.zeros((3 * kd,) + w.shape[1:], w.dtype).at[::3].set(w)
        return PK.strided_conv_packed(f, packed, w, out_valid, kw3=kw, band=band,
                                      wslack=wslack, inv=inv)

    return conv


@pytest.mark.parametrize("ks,stride,pad,cout", [g + (32,) for g in GEOMETRIES]
                         + [((3, 3, 3), (2, 2, 2), (1, 1, 1), 8)])
def test_strided_vjp_matches_pallas(ks, stride, pad, cout):
    """The port's spconv_downsample (rulebook, inverse rulebook, kh == 1
    weight expansion) under autograd against jax.vjp of efg_tpu's Pallas
    strided conv. cout 8 takes dW from the dW kernel over the forward
    rulebook, d_features still from the inverse."""
    cin = 16
    feats, coords, valid, shape = sites(13, c=cin)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    k = int(np.prod(ks))
    w = _rand(14, k, cin, cout, scale=0.1)

    def port(f, wt):
        out = TS.spconv_downsample(st_t.replace_features(f), wt, kernel_size=ks, stride=stride,
                                   padding=pad, max_out=96)
        port.sites = out
        return out.features

    g = _rand(15, 96, cout)
    got_out, got_df, got_dw = _torch_vjp(port, st_t.features.numpy(), w, g)
    o = port.sites
    conv = _jax_strided(st_j, jnp.asarray(o.keys.numpy()), jnp.asarray(o.coords.numpy()),
                        jnp.asarray(o.valid.numpy()), o.spatial_shape, ks, stride, pad, cin, cout)
    want_out, vjp = jax.vjp(conv, st_j.features, jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(g))
    close(got_out, want_out, "out")
    close(got_df, want_df, "d_features")
    close(got_dw, want_dw, "dW")
    assert np.abs(got_dw).max() > 0 and got_dw.shape == (k, cin, cout)
    assert K.launches == NO_LAUNCHES


@pytest.mark.parametrize("ks,stride,pad", GEOMETRIES + [((3, 3, 3), (2, 2, 1), (1, 1, 1))])
def test_strided_inverse_builder_matches_pallas(ks, stride, pad):
    """packed_inv and wmap bit for bit (the last case is the x-stride-1
    branch), on output sites from efg_tpu's own downsample."""
    st_j, st_t = both_tensors(*sites(16))
    out = S.spconv_downsample(st_j, jnp.zeros((int(np.prod(ks)), 5, 4)), kernel_size=ks,
                              stride=stride, padding=pad, max_out=96)
    want, want_map = PK.build_monotone_rule_strided_inverse(
        st_j, out.keys, out.spatial_shape, ks, stride, pad)
    got, got_map = K.build_monotone_rule_strided_inverse(
        st_t, torch.from_numpy(np.array(out.keys)), out.spatial_shape, ks, stride, pad)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_map == tuple(want_map)
    assert (got.numpy() & 7).any()  # some taps found


def _rule(seed, c):
    feats, coords, valid, shape = sites(seed, c=c)
    st_j, st_t = both_tensors(feats, coords, valid, shape)
    return st_j, st_t, K.build_monotone_rule9(st_t, 3)


def test_stacked_plain_matches_pallas_emit():
    """The stacked taps are the transpose of efg_tpu's [P·3·C, vt] buffer,
    equal bit for bit (a flag-masked bf16 copy)."""
    st_j, st_t, packed = _rule(17, 16)
    w = _rand(18, 27 * 16, 32, scale=0.1)
    want_out, want_st = PK.fused_gather_gemm(st_j.features, jnp.asarray(packed.numpy()),
                                             jnp.asarray(w), tile=128, emit_stacked=True)
    got_out, got_st = K.gather_gemm_stacked(st_t.features, packed, torch.from_numpy(w))
    v = packed.shape[1]
    assert got_st.dtype == torch.bfloat16 and got_st.shape == (v, 27 * 16)
    np.testing.assert_array_equal(got_st.float().numpy().T,
                                  np.asarray(want_st[:, :v], np.float32))
    close(got_out, want_out, "out")


def test_gather_dw_plain_matches_pallas():
    st_j, st_t, packed = _rule(19, 16)
    g = _rand(20, packed.shape[1], 32)
    want = PK.fused_gather_dw(st_j.features, jnp.asarray(packed.numpy()), jnp.asarray(g), tile=128)
    got = K.fused_gather_dw(st_t.features, packed, torch.from_numpy(g))
    assert got.shape == (27 * 16, 32)
    close(got, want, "dW")
    assert K.launches == NO_LAUNCHES
