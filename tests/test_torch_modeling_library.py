"""Port parity: the model library's shared pieces on the CPU — the loss
library (efg_tpu_torch/modeling/losses/), the registries
(modeling/registry.py, engine/registry.py), MultiGroupHead and the
"sample" box attention's gradients — against efg_tpu's.

The six losses at 1e-6 of each output's max (and the focal losses' and
GIoU's gradients); the registries' names after `_register_defaults`
equal to efg_tpu's, the trainer registry one object; MultiGroupHead from
flax variables drawn from numpy through the strict import at 1e-5; the
sampled box attention's value, grid and weight gradients against
`jax.vjp` at 1e-4 of each max.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

import efg_tpu.engine as JE
import efg_tpu.modeling as JMOD
import efg_tpu_torch.engine as TE
import efg_tpu_torch.modeling as TMOD
from efg_tpu.modeling import losses as JL
from efg_tpu.modeling.heads.multigroup_head import MultiGroupHead as JMultiGroupHead
from efg_tpu.ops import box_attention as JBA
from efg_tpu_torch.engine import trainer as TT
from efg_tpu_torch.modeling import losses as TL
from efg_tpu_torch.modeling.backbones.rpn import RPNFixBNMom
from efg_tpu_torch.modeling.heads.multigroup_head import MultiGroupHead
from efg_tpu_torch.ops import box_attention as TBA
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_conquer_ops import _close, fill_variables

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

LOSS_TOL = 1e-6


def _boxes2d(rs, n):
    xy = rs.uniform(0, 10, (n, 2))
    wh = rs.uniform(0.5, 4, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _boxes3d(rs, n):
    return np.concatenate([rs.uniform(-5, 5, (n, 3)), rs.uniform(0.5, 4, (n, 3)),
                           rs.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("name,kw", [
    ("sigmoid_focal_loss", {}), ("sigmoid_focal_loss", {"alpha": -1.0, "gamma": 1.5}),
    ("sigmoid_focal_loss_star", {}), ("sigmoid_focal_loss_star", {"alpha": 0.5, "gamma": 2.0}),
    ("smooth_l1_loss", {"beta": 0.5}), ("smooth_l1_loss", {"beta": 0.0}),
], ids=lambda v: v if isinstance(v, str) else ",".join(f"{k}={x}" for k, x in v.items()) or "-")
def test_elementwise_losses(name, kw):
    rs = np.random.RandomState(0)
    a = (rs.randn(4, 7) * 3).astype(np.float32)
    b = (rs.rand(4, 7) < 0.3).astype(np.float32) if "focal" in name \
        else (a + rs.randn(4, 7)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: getattr(JL, name)(x, jnp.asarray(b), **kw), jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = getattr(TL, name)(ta, torch.from_numpy(b), **kw)
    _close(got, want, LOSS_TOL, name)
    got.sum().backward()
    _close(ta.grad, vjp(jnp.ones_like(want))[0], LOSS_TOL, f"d {name}")


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_losses_2d(loss_type):
    rs = np.random.RandomState(1)
    p, t = _boxes2d(rs, 12), _boxes2d(rs, 12)
    p[3] = t[3]  # a perfect match
    p[5, 2:] = p[5, :2] - 0.5  # a degenerate (inverted) prediction
    want = JL.iou_loss_2d(jnp.asarray(p), jnp.asarray(t), loss_type)
    _close(TL.iou_loss_2d(torch.from_numpy(p), torch.from_numpy(t), loss_type), want, LOSS_TOL,
           loss_type)
    if loss_type == "giou":
        _close(TL.giou_loss_2d(torch.from_numpy(p), torch.from_numpy(t)),
               JL.giou_loss_2d(jnp.asarray(p), jnp.asarray(t)), LOSS_TOL, "giou_loss_2d")


def test_rotated_giou_3d_loss():
    """Random rotated pairs, an identical pair (loss 0) and overlapping
    pairs; the gradient wrt the predictions too, but for the identical
    pair, where every clip edge coincides with an edge of the other box (a
    kink: the two packages take different one-sided derivatives)."""
    rs = np.random.RandomState(2)
    t = _boxes3d(rs, 10)
    p = t + np.concatenate([rs.randn(10, 3) * 0.4, rs.randn(10, 3) * 0.2,
                            rs.randn(10, 1) * 0.3], -1).astype(np.float32)
    p[0] = t[0]
    p[1] = _boxes3d(rs, 1)[0]  # most likely disjoint
    want, vjp = jax.vjp(jax.jit(lambda x: JL.rotated_giou_3d_loss(x, jnp.asarray(t))),
                        jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    got = TL.rotated_giou_3d_loss(tp, torch.from_numpy(t))
    _close(got, want, LOSS_TOL, "rotated_giou_3d")
    assert abs(float(got[0].detach())) < 1e-6
    cot = np.ones(10, np.float32)
    cot[0] = 0.0
    got.backward(torch.from_numpy(cot))
    _close(tp.grad, vjp(jnp.asarray(cot))[0], 1e-5, "d rotated_giou_3d")


def _names(registries):
    return {r.name: sorted(r._obj_map) for r in registries}


def test_registries_are_efg_tpus():
    import efg_tpu.engine.trainer  # noqa: F401  (registers efg_tpu's DefaultTrainer)

    JMOD._register_defaults()
    TMOD._register_defaults()
    TMOD._register_defaults()  # a second call registers nothing twice
    regs = ("BACKBONES", "READERS", "HEADS", "LOSSES", "LAYERS")
    want = _names(getattr(JMOD, r) for r in regs)
    assert _names(getattr(TMOD, r) for r in regs) == want
    assert want["heads"] == ["CenterHead", "MultiGroupHead", "SepHead"]
    assert _names((TE.TRAINERS, TE.HOOKS)) == _names((JE.TRAINERS, JE.HOOKS))
    assert TE.TRAINERS is TT.TRAINERS and TE.TRAINERS.get("DefaultTrainer") is TT.DefaultTrainer
    rpn = RPNFixBNMom(8, layer_nums=(1,), ds_layer_strides=(1,), ds_num_filters=(8,),
                      us_layer_strides=(1,), us_num_filters=(8,))
    bn = rpn.block0_in.BatchNorm_0
    assert (bn.momentum, bn.eps) == (0.99, 1e-3)


@pytest.mark.parametrize("use_dir,bg_zeros", [(True, True), (False, False)])
def test_multigroup_head(use_dir, bg_zeros):
    tasks = [{"num_classes": 1}, {"num_classes": 2}]
    x = np.random.RandomState(3).randn(2, 5, 6, 16).astype(np.float32)
    jh = JMultiGroupHead(tasks=tasks, box_code_size=9, use_dir=use_dir,
                         encode_background_as_zeros=bg_zeros)
    shapes = jax.eval_shape(lambda: jh.init(jax.random.key(0), jnp.asarray(x)))
    variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, 4))
    want = jh.apply(variables, jnp.asarray(x))
    th = MultiGroupHead(16, tasks, box_code_size=9, use_dir=use_dir,
                        encode_background_as_zeros=bg_zeros)
    th.load_state_dict(flax_to_state_dict(th, variables))
    with torch.no_grad():
        got = th(torch.from_numpy(x))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            _close(g[k], w[k], 1e-5, k)
    fresh = MultiGroupHead(16, tasks)
    assert float(fresh.task0.conv_cls.bias[0]) == pytest.approx(-np.log(99.0), rel=1e-6)


def test_box_attention_sample_gradients():
    """The "sample" backend trains through autograd (gathers): its value,
    grid and weight gradients at two levels, taps off the map included."""
    rs = np.random.RandomState(7)
    b, l, nh, hd = 2, 9, 2, 4
    maps = [rs.randn(b, 6, 7, nh * hd).astype(np.float32),
            rs.randn(b, 3, 4, nh * hd).astype(np.float32)]
    grids = rs.uniform(-0.3, 1.3, (b, l, nh, 2, 9, 2)).astype(np.float32)
    aw = rs.rand(b, l, nh, 2, 9).astype(np.float32)
    cot = rs.randn(b, l, nh * hd).astype(np.float32)

    def jfn(m0, m1, g, a):
        return JBA.box_attention_sample([m0, m1], g, a, num_heads=nh)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(v) for v in (*maps, grids, aw)))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (*maps, grids, aw)]
    got = TBA.box_attention_sample(ts[:2], ts[2], ts[3], num_heads=nh)
    _close(got, want, 1e-5, "sample")
    got.backward(torch.from_numpy(cot))
    for name, t, g in zip(("value0", "value1", "grids", "attn_weights"), ts,
                          vjp(jnp.asarray(cot))):
        _close(t.grad, g, 1e-4, f"d{name}")
