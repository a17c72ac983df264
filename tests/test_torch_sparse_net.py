"""Port parity: sparse tensors, strided-conv output sites and the
SpMiddleResNetFHD trunk (efg_tpu_torch vs efg_tpu, same numpy inputs and
the same weights through the flax → torch mapper)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.modeling.backbones import sparse_net as JN
from efg_tpu.ops import sparse as S
from efg_tpu_torch.modeling.backbones import sparse_net as TN
from efg_tpu_torch.ops import sparse as TS
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_sparse_kernels import both_tensors, sites

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)


def fill_variables(shapes, seed):
    """Numpy values for a flax variable tree from `jax.eval_shape(init)`:
    fan-in-scaled kernels, non-trivial BN scale / bias / running stats."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rs.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.6, 1.4, shape).astype(np.float32)
        return rs.uniform(-0.2, 0.2, shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_from_batched_voxels_matches_jax():
    st_j, st_t = both_tensors(*sites(0, c=4))
    for name in ("keys", "coords", "valid", "features"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)))


@pytest.mark.parametrize(
    "ks,stride,pad,max_out,dense",
    [((3, 3, 3), (2, 2, 2), (1, 1, 1), 400, True),
     ((3, 3, 3), (2, 2, 2), (0, 1, 1), 400, False),  # sort branch
     ((3, 1, 1), (2, 1, 1), (0, 0, 0), 400, True),
     ((3, 3, 3), (2, 2, 2), (1, 1, 1), 70, True),  # truncation, dense grid
     ((3, 3, 3), (2, 2, 2), (1, 1, 1), 70, False)],  # truncation, sort branch
)
def test_downsample_sites_match_jax(ks, stride, pad, max_out, dense, monkeypatch):
    """Output keys / coords / valid exact on both dedup branches, including
    first-come truncation in key order over the whole batch."""
    if not dense:
        monkeypatch.setattr(S, "DENSE_GRID_LIMIT", 0)
        monkeypatch.setattr(TS, "DENSE_GRID_LIMIT", 0)
    st_j, st_t = both_tensors(*sites(1, c=4))
    k = int(np.prod(ks))
    w = np.random.RandomState(2).randn(k, 4, 16).astype(np.float32) * 0.1
    want = S.spconv_downsample(st_j, jnp.asarray(w), kernel_size=ks, stride=stride,
                               padding=pad, max_out=max_out)
    got = TS.spconv_downsample(st_t, torch.from_numpy(w), kernel_size=ks, stride=stride,
                               padding=pad, max_out=max_out)
    for name in ("keys", "coords", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert got.spatial_shape == want.spatial_shape
    if max_out == 70:
        assert bool(got.valid.all())  # more candidates than slots: truncated
    # features: the XLA gather-GEMM rounds the same inputs to bf16 and sums
    # exact products in f32, as the port does; only summation order differs
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), rtol=1e-4, atol=1e-4)


GRID = (32, 32, 40)  # (nx, ny, nz) → spatial (41, 32, 32) → BEV 4×4, D=2


@pytest.mark.parametrize("act_dtype,tol", [("", 1e-2), ("bfloat16", 2e-2)])
def test_sp_middle_resnet_fhd_matches_jax(act_dtype, tol):
    """The trunk's BEV [B, H, W, C·D] under shared weights. Caps sit above
    occupancy so the convs, not the truncation, are compared.

    Tolerance, relative to the map's largest value: every conv rounds its
    inputs to bf16, so a last-bit difference upstream (summation order)
    flips some roundings and the flips compound over 21 convs — efg_tpu's
    own bf16 trunk differs from its f32 trunk by the same order (0.6% of
    max|BEV| on this input). Observed here: 0.5% (f32 activations) and
    0.7% (bf16 activations; the XLA path also rounds each conv output to
    bf16 before its bias, the port after)."""
    feats, coords, valid, _ = sites(3, bsz=2, n=300, cap=320, c=5, shape=(41, 32, 32))
    kw = dict(num_input_features=5, grid_size=GRID, stage_caps=(320, 320, 320, 320),
              act_dtype=act_dtype)
    jm = JN.SpMiddleResNetFHD(sparse_backend="xla", **kw)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args, False))
    variables = fill_variables(shapes, 4)
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, False))(variables, *args), np.float32)

    tm = TN.SpMiddleResNetFHD(**kw)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(valid))
    assert got.shape == want.shape == (2, 4, 4, 256)
    assert tm.num_bev_channels == 256
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * scale)
    # the sparsity pattern (which BEV cells / channels are live) agrees
    assert ((got.float().numpy() != 0) != (want != 0)).mean() < 2e-3
