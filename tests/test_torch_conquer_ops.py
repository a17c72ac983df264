"""Port parity: the ops and layers of ConQueR / Voxel-DETR serving
(efg_tpu_torch vs efg_tpu on the same numpy inputs and mapped weights).

The box-attention functions (`kernel_indices`, `make_box_grids`,
`bin_window_coeffs`, the dense and gather window ops, `box_attention_sample`),
the FPN, the sine position encoding, and one encoder and one decoder layer,
each at a tiny size. Every window case puts taps and window cells outside
the map. The window ops round V (and the dense op A) to bf16 in both
packages; the gather op's A stays f32 as efg_tpu's CPU run keeps it
(`GATHER_DOT_DTYPE` switched), so the functions agree to f32 summation
order: 1e-5 of each output's range."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.modeling.backbones import fpn as JF
from efg_tpu.models import voxel_detr as JVD
from efg_tpu.ops import box_attention as JBA
from efg_tpu_torch.modeling.backbones import fpn as TF
from efg_tpu_torch.models import voxel_detr as TVD
from efg_tpu_torch.ops import box_attention as TBA
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_gather(monkeypatch):
    monkeypatch.setattr(TBA, "GATHER_DOT_DTYPE", torch.float32)


def fill_variables(shapes, seed):
    """Numpy values for every leaf of a flax variable tree (from
    `jax.eval_shape` of its init), drawn in tree order from one seed:
    kernels scaled by 1/√fan_in (an MHA's [C, NH, hd] projections by C),
    norm scales and BN variances in [0.6, 1.4], biases and means in
    [−0.2, 0.2]. Nothing is left at efg_tpu's zero or constant inits, so the
    box-attention offsets and weights vary with the query."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            mha_in = len(shape) == 3 and keys[-2] in ("query", "key", "value")
            fan_in = shape[0] if mha_in else int(np.prod(shape[:-1]))
            return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.6, 1.4, shape).astype(np.float32)
        return rs.uniform(-0.2, 0.2, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, want, tol=F32_TOL, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-6)
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|Δ| {err} > {tol} · {scale}"
    return err / scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", [3, 4, 5])
def test_kernel_indices(k):
    _close(TBA.kernel_indices(k), JBA.kernel_indices(k), what=f"k={k}")


@pytest.mark.parametrize("rotation", [True, False])
def test_make_box_grids(rotation):
    rs = np.random.RandomState(1)
    ref_boxes = rs.uniform(0, 1, (2, 7, 1, 1, 4)).astype(np.float32)
    ref_angles = rs.uniform(0, 1, (2, 7, 1, 1, 1)).astype(np.float32)
    off = rs.randn(2, 7, 4, 1, 4).astype(np.float32)
    off_a = rs.randn(2, 7, 4, 1, 1).astype(np.float32) if rotation else None
    want = JBA.make_box_grids(jnp.asarray(ref_boxes), jnp.asarray(ref_angles), jnp.asarray(off),
                              None if off_a is None else jnp.asarray(off_a),
                              JBA.kernel_indices(5))
    got = TBA.make_box_grids(_t(ref_boxes), _t(ref_angles), _t(off),
                             None if off_a is None else _t(off_a), TBA.kernel_indices(5))
    assert got.shape == (2, 7, 4, 1, 25, 2)
    _close(got, want, what="grids")


def _window_inputs(seed, b=2, l=37, nh=4, h=11, w=13, radius=4, spread=0.6):
    """Grids reaching past the map and past the window, softmaxed weights,
    in-map anchors (the corners among them)."""
    rs = np.random.RandomState(seed)
    grids = rs.uniform(-spread, 1 + spread, (b, l, nh, 1, 25, 2)).astype(np.float32)
    aw = rs.rand(b, l, nh, 1, 25).astype(np.float32)
    aw /= aw.sum(-1, keepdims=True)
    base = np.stack([rs.randint(0, h, (b, l)), rs.randint(0, w, (b, l))], -1).astype(np.int32)
    base[0, :4] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0]]
    return grids, aw, base


@pytest.mark.parametrize("radius", [4, 8])
def test_bin_window_coeffs(radius):
    grids, aw, base = _window_inputs(2, radius=radius)
    want = JBA.bin_window_coeffs(jnp.asarray(grids), jnp.asarray(aw), jnp.asarray(base),
                                 11, 13, radius)
    got = TBA.bin_window_coeffs(_t(grids), _t(aw), _t(base), 11, 13, radius)
    assert got.dtype == torch.float32 and got.shape == (2, 37, 4, (2 * radius + 1) ** 2)
    _close(got, want, what="coeffs")
    # taps off the map were planted, and they add nothing
    assert float(np.asarray(want).sum()) < 0.999 * aw.sum()


def test_window_dense_matches_dense_mxu():
    """The encoder's op on a map that is no multiple of efg_tpu's 8×16
    query tiles, random coefficients on every bin (the edge bins read the
    zero padding)."""
    rs = np.random.RandomState(3)
    b, h, w, nh, hd, r = 2, 11, 21, 4, 8, 4
    value = rs.randn(b, h, w, nh * hd).astype(np.float32)
    coeffs = rs.rand(b, h * w, nh, (2 * r + 1) ** 2).astype(np.float32)
    want = JBA.box_attention_window_dense_mxu(jnp.asarray(value), jnp.asarray(coeffs),
                                              num_heads=nh, radius=r)
    got = TBA.box_attention_window_dense(_t(value), _t(coeffs), num_heads=nh, radius=r)
    _close(got, want, what="dense window")


@pytest.mark.parametrize("chunk", [512, 16])
def test_window_gather_matches_runs(f32_gather, chunk):
    """The decoder's op (efg_tpu's runs path) with anchors on every corner
    and random coefficients on every bin; the port's chunking is free."""
    rs = np.random.RandomState(4)
    b, h, w, nh, hd, r, l = 2, 12, 10, 4, 8, 8, 37
    value = rs.randn(b, h, w, nh * hd).astype(np.float32)
    coeffs = rs.rand(b, l, nh, (2 * r + 1) ** 2).astype(np.float32)
    _, _, base = _window_inputs(5, b=b, l=l, h=h, w=w)
    want = JBA.box_attention_window_gather(jnp.asarray(value), jnp.asarray(coeffs),
                                           jnp.asarray(base), num_heads=nh, radius=r)
    got = TBA.box_attention_window_gather(_t(value), _t(coeffs), _t(base), num_heads=nh,
                                          radius=r, chunk=chunk)
    _close(got, want, what="gather window")


def test_window_gather_bf16_products():
    """With GATHER_DOT_DTYPE bf16 (the card's setting, efg_tpu's
    accelerator `_dot_dtype`), A is rounded to bf16 before the products:
    the port's own f32 result on bf16-rounded A, bit for bit."""
    rs = np.random.RandomState(6)
    value = _t(rs.randn(1, 9, 9, 16).astype(np.float32))
    coeffs = _t(rs.rand(1, 5, 2, 81).astype(np.float32))
    base = _t(rs.randint(0, 9, (1, 5, 2)).astype(np.int32))
    assert TBA.GATHER_DOT_DTYPE == torch.bfloat16
    got = TBA.box_attention_window_gather(value, coeffs, base, num_heads=2, radius=4)
    rounded = coeffs.to(torch.bfloat16).float()
    TBA.GATHER_DOT_DTYPE = torch.float32
    try:
        want = TBA.box_attention_window_gather(value, rounded, base, num_heads=2, radius=4)
    finally:
        TBA.GATHER_DOT_DTYPE = torch.bfloat16
    assert torch.equal(got, want)


def test_box_attention_sample():
    rs = np.random.RandomState(7)
    b, l, nh, hd = 2, 9, 2, 4
    maps = [rs.randn(b, 6, 7, nh * hd).astype(np.float32),
            rs.randn(b, 3, 4, nh * hd).astype(np.float32)]
    grids = rs.uniform(-0.3, 1.3, (b, l, nh, 2, 9, 2)).astype(np.float32)
    aw = rs.rand(b, l, nh, 2, 9).astype(np.float32)
    want = JBA.box_attention_sample([jnp.asarray(m) for m in maps], jnp.asarray(grids),
                                    jnp.asarray(aw), num_heads=nh)
    got = TBA.box_attention_sample([_t(m) for m in maps], _t(grids), _t(aw), num_heads=nh)
    _close(got, want, what="sample")


def _flax_and_port(jmod, tmod, *args, seed=0, **kwargs):
    """Init-free flax variables (every leaf from `seed`), the port module
    loaded with them, and the flax module's jitted output."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), *args, **kwargs))
    variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, seed))
    want = jax.jit(lambda v: jmod.apply(v, *args, **kwargs))(variables)
    tmod.load_state_dict(flax_to_state_dict(tmod, variables))
    tmod.eval()
    return want


def test_fpn_matches_jax():
    """Every level (p2-p4 and the top block p5) in eval mode, and the
    requested-levels path equals the full one."""
    rs = np.random.RandomState(8)
    chans = {"res2": 12, "res3": 24, "res4": 16}
    feats = {k: rs.randn(2, 16 // 2 ** i, 20 // 2 ** i, c).astype(np.float32)
             for i, (k, c) in enumerate(chans.items())}
    jm = JF.FPN(in_features=tuple(chans), out_channels=32)
    tm = TF.FPN(chans, out_channels=32)
    want = _flax_and_port(jm, tm, {k: jnp.asarray(v) for k, v in feats.items()}, False)
    with torch.no_grad():
        got = tm({k: _t(v) for k, v in feats.items()})
        only = tm({k: _t(v) for k, v in feats.items()}, levels=("p3",))
    assert set(got) == set(want) == {"p2", "p3", "p4", "p5"}
    for k in want:
        _close(got[k], want[k], what=k)
    assert list(only) == ["p3"] and torch.equal(only["p3"], got["p3"])


def test_position_embedding_sine():
    x = np.zeros((2, 7, 9, 32), np.float32)
    want = JF.PositionEmbeddingSine(16).apply({}, jnp.asarray(x))
    _close(TF.position_embedding_sine(_t(x), 16), want, what="pos")


def _ref_windows(h, w, b=2):
    return TVD.VoxelDETR.ref_windows([(h, w)], b, torch.float32, "cpu").numpy()


def test_encoder_layer_matches_jax():
    """One encoder layer (window self-attention anchored at each cell).
    Tolerance 2e-3 of range: both round V and A to bf16, and a last-bit
    difference in the f32 projections before them flips some roundings."""
    rs = np.random.RandomState(9)
    h, w, d = 6, 7, 32
    src = rs.randn(2, h * w, d).astype(np.float32)
    pos = rs.randn(2, h * w, d).astype(np.float32)
    ref = _ref_windows(h, w)
    jm = JVD.EncoderLayer(d, 4, 1, 64)
    tm = TVD.EncoderLayer(d, 4, 1, 64)
    want = _flax_and_port(jm, tm, jnp.asarray(src), jnp.asarray(pos), [(h, w)],
                          jnp.asarray(ref), False, seed=1)
    with torch.no_grad():
        got = tm(_t(src), _t(pos), [(h, w)], _t(ref))
    _close(got, want, tol=2e-3, what="encoder layer")


@pytest.mark.parametrize("idx", [0, 1])
def test_decoder_layer_matches_jax(f32_gather, idx):
    """One decoder layer (self-attention under a denoising-style mask,
    rotated box cross-attention around each query's box) at layer index 0
    and 1. Tolerance as the encoder's."""
    rs = np.random.RandomState(10 + idx)
    h, w, d, t = 9, 8, 32, 12
    query = rs.randn(2, t, d).astype(np.float32)
    memory = rs.randn(2, h, w, d).astype(np.float32)
    ref = np.concatenate([rs.uniform(0.05, 0.95, (2, t, 7)), rs.rand(2, t, 3)], -1)
    ref[..., 3:5] = rs.uniform(0.05, 0.3, (2, t, 2))
    ref = ref.astype(np.float32)
    group = np.arange(t) // 4
    mask = group[:, None] == group[None, :]
    jm = JVD.DecoderLayer(d, 4, 1, 64)
    tm = TVD.DecoderLayer(d, 4, 1, 64)
    want = _flax_and_port(jm, tm, idx, jnp.asarray(query), [jnp.asarray(memory)],
                          jnp.asarray(ref), False, attn_mask=jnp.asarray(mask), seed=2 + idx)
    with torch.no_grad():
        got = tm(idx, _t(query), [_t(memory)], _t(ref), attn_mask=_t(mask))
        free = tm(idx, _t(query), [_t(memory)], _t(ref))
    _close(got, want, tol=2e-3, what="decoder layer")
    assert float((free - got).abs().max()) > 1e-3  # the mask changes the result
