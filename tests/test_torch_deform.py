"""Port parity: deformable convolution (efg_tpu_torch/ops/deform_conv.py)
and the deformable ResNet stages against efg_tpu's, on the CPU in f32.

`deform_conv2d` v1 and v2, stride 1 and 2, with offsets that carry taps
off the map, at 1e-5 of the output's max; its input, offset, weight (and
modulation) gradients against `jax.vjp` of efg_tpu's at 1e-4 of each max.
A deformable BottleneckBlock (v1 at stride 1; v2 at stride 2) from flax
variables drawn from numpy through the strict weight import, at 1e-4. A
ResNet-50 with `deform_on_per_stage=(False, True, True, True)` imported
leaf for leaf from `jax.eval_shape` of efg_tpu's init (its forward is not
compared: a whole-trunk JAX compile costs tens of seconds; the blocks
above hold what it is built from).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.modeling.backbones import resnet as JR
from efg_tpu.ops import deform_conv as JD
from efg_tpu_torch.modeling.backbones import resnet as TR
from efg_tpu_torch.ops import deform_conv as TD
from efg_tpu_torch.utils.jax_import import flax_names, flax_to_state_dict

from test_torch_conquer_ops import _close, fill_variables

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

F32_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed, b=2, h=9, w=11, cin=5, cout=6, stride=1, modulated=False):
    """x [B, H, W, Cin], offsets of up to ±4 pixels (taps leave the map at
    every edge), weights HWIO, the v2 modulation logits."""
    rs = np.random.RandomState(seed)
    ho, wo = (h + 2 - 3) // stride + 1, (w + 2 - 3) // stride + 1
    x = rs.randn(b, h, w, cin).astype(np.float32)
    off = rs.uniform(-4, 4, (b, ho, wo, 18)).astype(np.float32)
    wts = (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    mod = rs.randn(b, ho, wo, 9).astype(np.float32) if modulated else None
    return x, off, wts, mod


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv2d_forward_and_vjp(stride, modulated):
    x, off, wts, mod = _inputs(3 + stride, stride=stride, modulated=modulated)
    args = [x, off, wts] + ([mod] if modulated else [])

    def jfn(*a):
        return JD.deform_conv2d(a[0], a[1], a[2], stride=stride, padding=1,
                                modulation=a[3] if modulated else None)

    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = TD.deform_conv2d(ts[0], ts[1], ts[2], stride=stride, padding=1,
                           modulation=ts[3] if modulated else None)
    _close(got, want, F32_TOL, "out")
    # some taps lie off the map, so the zero-padding branch runs
    assert np.abs(off).max() > 3.5
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    for name, t, g in zip(("x", "offsets", "weights", "modulation"), ts, jgrads):
        _close(t.grad, g, GRAD_TOL, f"d{name}")


def _block_case(modulated, stride, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 10, 12, 16).astype(np.float32)
    jb = JR.BottleneckBlock(32, 8, stride=stride, deform=True, deform_modulated=modulated)
    shapes = jax.eval_shape(lambda: jb.init(jax.random.key(0), jnp.asarray(x), False))
    variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, seed))
    return x, jb, variables


@pytest.mark.parametrize("modulated,stride", [(False, 1), (True, 2)], ids=["v1", "v2_stride2"])
def test_deformable_bottleneck_block(modulated, stride):
    x, jb, variables = _block_case(modulated, stride, 7 + stride)
    want = jb.apply(variables, jnp.asarray(x), False)
    tb = TR.BottleneckBlock(16, 32, 8, stride=stride, deform=True, deform_modulated=modulated)
    tb.load_state_dict(flax_to_state_dict(tb, variables))
    assert isinstance(tb.conv2, TD.DeformConv) and tb.conv2.modulated == modulated
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want, GRAD_TOL, "block")


def test_deformable_resnet50_imports_leaf_for_leaf(monkeypatch):
    """Every leaf of efg_tpu's deformable ResNet-50 (v2 on res3-res5) has
    one tensor of the port's, with its shape; the offset convs and the
    deformable kernels among them; a fresh DeformConv's offsets are 0. The
    port's msra draws (a truncated normal, 11 s for a ResNet-50 here) are
    skipped: the import overwrites every tensor."""
    monkeypatch.setattr(TR, "msra_", lambda weight, generator=None: weight)
    deform = (False, True, True, True)
    jm = JR.ResNet(depth=50, deform_on_per_stage=deform, deform_modulated=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), False))
    variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, 5))
    tm = TR.ResNet(depth=50, deform_on_per_stage=deform, deform_modulated=True)
    sd = flax_to_state_dict(tm, variables)  # strict: raises on any leaf left over or missing
    tm.load_state_dict(sd)
    names = flax_names(tm)
    deformable = [k for k, (_, p) in names.items() if "offset_conv" in p]
    # 2 leaves (kernel, bias) per deformable block of res3 (4), res4 (6), res5 (3)
    assert len(deformable) == 2 * (4 + 6 + 3)
    assert names["res3_block0.conv2.weight"] == ("params", ("res3_block0", "conv2", "kernel"))
    assert tuple(sd["res3_block0.conv2.offset_conv.weight"].shape) == (27, 128, 3, 3)
    assert isinstance(tm.res2_block0.conv2, TR.Conv2d)
    fresh = TD.DeformConv(8, 8, stride=2, modulated=True)
    assert not fresh.offset_conv.weight.any() and not fresh.offset_conv.bias.any()
    with pytest.raises(ValueError, match="neither deform nor dilation"):
        TR.ResNet(depth=18, deform_on_per_stage=(True, False, False, False))
    with pytest.raises(ValueError, match="dilation"):
        TR.ResNet(depth=50, deform_on_per_stage=(False, False, False, True), res5_dilation=2)
