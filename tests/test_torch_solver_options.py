"""Port parity: the optimizers, gradient clip and schedule that efg_tpu
builds from a config key and the earlier slices left out — Adam,
AdamWMulti, Adafactor, LARS_SGD, `clip_type: value` and
LinearWarmupCosineAnnealing (efg_tpu_torch/solver/ against
efg_tpu/solver/), on the CPU.

Each optimizer runs three steps of the same numpy gradients on a small
tree of matrix and vector leaves through efg_tpu's `build_optimizer`
(optax) and the port's: every leaf within 1e-6 of its max after each step
(1e-5 for Adafactor, whose factored moments and block RMS reduce in
another order). The tree holds a 130 × 140 leaf, so Adafactor's factored
path runs beside its plain one. AdamWMulti runs on a module of two
groups, and its multipliers are paired leaf for leaf with efg_tpu's on
ConQueR's whole tree. Adafactor decides its moments on the flax leaf
shapes: its state's shapes equal optax's on every leaf of a ConQueR and a
Mask2Former whose attention is 128 wide, and three steps on a tree of an
MHA at C = 128 (the kernels that torch holds as [128, 128] Linears), a
Dense, a conv, a transposed conv and a norm match optax's within 1e-5.
The schedule is exact in f32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
import optax
from torch import nn

from efg_tpu.solver import optimizers as JO
from efg_tpu.solver import schedulers as JS
from efg_tpu_torch.solver import optimizers as TO
from efg_tpu_torch.solver import schedulers as TS
from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.modeling.common.layers import MultiHeadDotProductAttention
from efg_tpu_torch.utils.jax_import import flax_names, flax_to_state_dict

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

SHAPES = {"a_kernel": (6, 5), "b_bias": (5,), "c_big": (130, 140), "d_conv": (3, 3, 4, 8),
          "e_scale": (8,)}
STEPS = 3


def _lr(step):
    return 1e-2 / (1.0 + jnp.asarray(step, jnp.float32))


def _lr_t(step):
    return torch.tensor(1e-2, dtype=torch.float32) / (1.0 + torch.tensor(float(step)))


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()}


class _Leaves(nn.Module):
    """The tree's leaves as parameters the module holds itself (flax
    `self.param` leaves: the same shape in both packages)."""

    def __init__(self, tree):
        super().__init__()
        self.flax_params = tuple(sorted(tree))
        for k in self.flax_params:
            self.register_parameter(k, nn.Parameter(torch.from_numpy(tree[k].copy())))


def _run(cfg, clip=None, tol=1e-6):
    """STEPS updates of the same gradients through both packages; each leaf
    within `tol` of its max after every step."""
    params = _tree(0)
    grads = [_tree(10 + k, scale=3.0) for k in range(STEPS)]
    jtx = JO.build_optimizer(cfg, _lr, grad_clip_cfg=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    module = _Leaves(params)
    ttx = TO.build_optimizer(cfg, _lr_t, grad_clip_cfg=clip, module=module)
    names = sorted(SHAPES)
    tp = [p.data for p in module.parameters()]
    tstate = ttx.init(tp)
    for k in range(STEPS):
        upd, jstate = jtx.update({n: jnp.asarray(v) for n, v in grads[k].items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.step(tp, [torch.from_numpy(grads[k][n]) for n in names], tstate)
        for n, t in zip(names, tp):
            want = np.asarray(jp[n])
            err = float(np.abs(t.numpy() - want).max())
            assert err <= tol * float(np.abs(want).max()), (cfg["type"], k, n, err)
    assert tstate.count == STEPS
    return ttx


def test_adam():
    tx = _run({"type": "Adam", "betas": [0.9, 0.98], "eps": 1e-7})
    assert tx.weight_decay is None and tx.betas == (0.9, 0.98)


def test_adam_ignores_the_momentum_schedule():
    """efg_tpu's Adam drops a OneCycle β1 schedule; so does the port's."""
    tx = TO.build_optimizer({"type": "Adam"}, _lr_t, lambda k: 0.5)
    assert tx.momentum_schedule is None and tx.betas == (0.9, 0.999)


@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "value_clip"])
def test_adafactor(clip):
    cfg = {"enabled": True, "clip_type": "value", "params": {"clip_value": clip}} if clip else None
    _run({"type": "Adafactor", "weight_decay": 1e-3}, clip=cfg, tol=1e-5)
    assert TO.factored_dims((130, 140)) == (0, 1) and TO.factored_dims((6, 5)) is None
    assert TO.factored_dims((3, 3, 4, 8)) is None and TO.factored_dims((128, 3, 128)) == (0, 2)


def _adafactor_shapes(state):
    """The shapes of optax's adafactor state (v_row, v_col, v) by flax
    path, read from its FactoredState."""
    factored = next(s for s in state if hasattr(s, "v_row"))
    out = {}
    for field in ("v_row", "v_col", "v"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(getattr(factored, field))[0]:
            out.setdefault(tuple(p.key for p in path), []).append(tuple(leaf.shape))
    return {k: tuple(v) for k, v in out.items()}


def _decisions_pair(params_shapes, module):
    """Every leaf's Adafactor state shapes in both packages, paired by flax
    path: optax's from `jax.eval_shape` of its init on the abstract tree,
    the port's from its init on the module."""
    jstate = jax.eval_shape(JO.build_optimizer({"type": "Adafactor"}, _lr).init, params_shapes)
    want = _adafactor_shapes(jstate)
    tx = TO.build_optimizer({"type": "Adafactor"}, _lr_t, module=module)
    state = tx.init([p.data for p in module.parameters()])
    names = flax_names(module)
    got = {names[n][1]: (tuple(r.shape), tuple(c.shape), tuple(v.shape))
           for (n, _), r, c, v in zip(module.named_parameters(), state.v_row, state.v_col,
                                       state.v)}
    assert set(got) == set(want)
    for path, shapes in want.items():
        assert got[path] == shapes, (path, got[path], shapes)
    return want


def test_adafactor_factors_conquer_as_optax():
    """ConQueR at hidden 128, 4 heads (tests/test_torch_conquer.py's KW
    otherwise): every leaf's factoring decision and moment shapes equal
    optax's; the MHA kernels [128, 4, 32] keep a full moment."""
    from efg_tpu.models import conquer as JCQ
    from efg_tpu.models import voxel_detr as JVD
    from efg_tpu_torch.models import conquer as TCQ
    from efg_tpu_torch.models import voxel_detr as TVD

    from test_torch_conquer import CONTRAS_DIM, KW, _cloud

    kw = dict(KW, hidden_dim=128, num_head=4)
    pts, mask = _cloud(0, n=256)
    jm = JCQ.ConQueRModule(detr=JVD.VoxelDETR(**kw), contras_dim=CONTRAS_DIM, num_classes=3)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(pts),
                                            jnp.asarray(mask), False))
    tm = TCQ.ConQueRModule(TVD.VoxelDETR(**kw, device="cpu"), contras_dim=CONTRAS_DIM)
    want = _decisions_pair(shapes["params"], tm)
    mha = [p for p, s in want.items() if p[-1] == "kernel" and s[2] in ((128, 4, 32), (4, 32, 128))]
    assert mha and all(want[p][0] == (1,) for p in mha)  # not factored
    assert any(s[0] != (1,) for s in want.values())  # some leaf is


def test_adafactor_factors_mask2former_as_optax():
    """A Mask2Former whose attention is 128 wide (R-18, 8 queries, 1
    decoder layer): every leaf's decision and moment shapes equal optax's."""
    from efg_tpu.models import mask2former as JM2
    from efg_tpu_torch.models import mask2former as TM2

    model = dict(num_classes=4, num_queries=8, d_model=128, dec_layers=1, depth=18, freeze_at=0)
    images = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JM2.Mask2Former(**model).init(jax.random.key(0), images, True))
    want = _decisions_pair(shapes["params"], TM2.Mask2Former(**model, device="cpu"))
    assert any(s[2] == (128, 8, 16) and s[0] == (1,) for s in want.values())


class _AttnTree(nn.Module):
    """flax {"attn": MHA C 128 / 4 heads, "dense": Dense 128→140, "conv":
    Conv 3×3 128→136, "up": ConvTranspose 2×2 136→130, "norm": LayerNorm}
    in torch."""

    def __init__(self):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(128, 4)
        self.dense = nn.Linear(128, 140)
        self.conv = Conv2d(128, 136, 3, bias=True, dtype=None)
        self.up = ConvTranspose2d(136, 130, 2, dtype=None)
        self.norm = nn.LayerNorm(128)


def _attn_flax(rs, scale=1.0):
    def a(*shape):
        return (rs.randn(*shape) * scale).astype(np.float32)

    attn = {n: {"kernel": a(128, 4, 32), "bias": a(4, 32)} for n in ("query", "key", "value")}
    attn["out"] = {"kernel": a(4, 32, 128), "bias": a(128)}
    return {"attn": attn, "dense": {"kernel": a(128, 140), "bias": a(140)},
            "conv": {"kernel": a(3, 3, 128, 136), "bias": a(136)},
            "up": {"kernel": a(2, 2, 136, 130)}, "norm": {"scale": a(128), "bias": a(128)}}


@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "value_clip"])
def test_adafactor_attention_tree(clip):
    """Three Adafactor steps of efg_tpu (optax) and the port on the tree of
    an MHA at C = 128 (its [128, 4, 32] kernels a full moment, the Dense
    and both convs factored), through `flax_to_state_dict`: every leaf
    within 1e-5 of its max after each step."""
    rs = np.random.RandomState(3)
    flax = _attn_flax(rs)
    cfg = {"type": "Adafactor", "weight_decay": 1e-3}
    clip_cfg = {"enabled": True, "clip_type": "value", "params": {"clip_value": clip}} \
        if clip else None
    module = _AttnTree()
    module.load_state_dict(flax_to_state_dict(module, {"params": flax}))
    jtx = JO.build_optimizer(cfg, _lr, grad_clip_cfg=clip_cfg)
    ttx = TO.build_optimizer(cfg, _lr_t, grad_clip_cfg=clip_cfg, module=module)
    params = [p.data for p in module.parameters()]
    jp = jax.tree_util.tree_map(jnp.asarray, flax)
    jstate, tstate = jtx.init(jp), ttx.init(params)
    update = jax.jit(jtx.update)  # one compile, not one a jnp op and leaf
    for k in range(STEPS):
        gflax = _attn_flax(rs, scale=3.0)
        upd, jstate = update(jax.tree_util.tree_map(jnp.asarray, gflax), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        g = _AttnTree()
        g.load_state_dict(flax_to_state_dict(g, {"params": gflax}))
        ttx.step(params, [q.detach() for q in g.parameters()], tstate)
        want = flax_to_state_dict(module, {"params": jax.tree_util.tree_map(np.asarray, jp)})
        for n, q in module.named_parameters():
            w = want[n].numpy()
            err = float(np.abs(q.detach().numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (k, n, err)


def test_adafactor_needs_the_module():
    """Without the module Adafactor cannot read its leaves' flax shapes:
    build_optimizer raises, as for AdamWMulti."""
    with pytest.raises(ValueError, match="needs the module"):
        TO.build_optimizer({"type": "Adafactor"}, _lr_t)


def test_lars_sgd():
    _run({"type": "LARS_SGD", "momentum": 0.8, "weight_decay": 1e-3, "trust_coefficient": 0.01})


def test_lars_zero_leaf_keeps_ratio_one():
    """A zero parameter or update takes trust ratio 1, as optax's
    `scale_by_trust_ratio`."""
    tx = TO.build_optimizer({"type": "LARS_SGD", "weight_decay": 0.0}, lambda k: 0.1)
    p, g = [torch.zeros(3)], [torch.ones(3)]
    tx.step(p, g, tx.init(p))
    torch.testing.assert_close(p[0], torch.full((3,), -0.1), rtol=0, atol=0)


def test_value_clip_before_adamw():
    """`clip_type: value` (optax.clip) ahead of AdamW: the gradients reach
    ±3 and more, clipped at 0.5."""
    clip = {"enabled": True, "clip_type": "value", "params": {"clip_value": 0.5}}
    tx = _run({"type": "AdamW", "weight_decay": 1e-2}, clip=clip)
    assert tx.clip_value == 0.5 and tx.max_norm is None
    with pytest.raises(ValueError, match="Unknown clip_type"):
        TO.build_optimizer({"type": "AdamW"}, _lr_t,
                           grad_clip_cfg={"enabled": True, "clip_type": "l1"})


class _TwoGroups(nn.Module):
    """flax {"backbone": Dense 6→5, "head": {"fc": Dense 5→3}} in torch."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Linear(6, 5)
        self.head = nn.Module()
        self.head.fc = nn.Linear(5, 3)


def test_adamw_multi_two_groups():
    """AdamWMulti on two groups (the backbone at 0.1 of the lr): efg_tpu's
    multi_transform of adamw against the port's per-parameter lr."""
    rs = np.random.RandomState(1)
    flax = {"backbone": {"kernel": rs.randn(6, 5), "bias": rs.randn(5)},
            "head": {"fc": {"kernel": rs.randn(5, 3), "bias": rs.randn(3)}}}
    flax = jax.tree_util.tree_map(lambda a: a.astype(np.float32), flax)
    cfg = {"type": "AdamWMulti", "weight_decay": 0.05, "lr_multipliers": {"backbone": 0.1}}
    module = _TwoGroups()
    module.load_state_dict(flax_to_state_dict(module, {"params": flax}))
    jtx = JO.build_optimizer(cfg, _lr)
    ttx = TO.build_optimizer(cfg, _lr_t, module=module)
    assert ttx.lr_mults == [0.1, 0.1, 1.0, 1.0] and ttx.eps == 1e-9
    params = list(module.parameters())
    jp = jax.tree_util.tree_map(jnp.asarray, flax)
    jstate, tstate = jtx.init(jp), ttx.init(params)
    for k in range(STEPS):
        gflax = jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(np.float32), flax)
        upd, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, gflax), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        g = _TwoGroups()
        g.load_state_dict(flax_to_state_dict(g, {"params": gflax}))
        ttx.step(params, [q.detach() for q in g.parameters()], tstate)
        want = flax_to_state_dict(module, {"params": jax.tree_util.tree_map(np.asarray, jp)})
        for n, q in module.named_parameters():
            w = want[n].numpy()
            assert float(np.abs(q.detach().numpy() - w).max()) <= 1e-6 * float(np.abs(w).max()), n
    with pytest.raises(ValueError, match="needs the module"):
        TO.build_optimizer(cfg, _lr_t)


def _jax_labels(cfg, params_shapes):
    """efg_tpu's AdamWMulti label of every leaf ("m<mult>"), read from the
    masked inner states of its multi_transform on the abstract tree."""
    tx = JO.build_optimizer(cfg, _lr)
    state = jax.eval_shape(tx.init, params_shapes)
    labels = {}
    for label, inner in state.inner_states.items():
        mu = inner.inner_state[0].mu
        for path, _ in jax.tree_util.tree_flatten_with_path(mu)[0]:
            labels[tuple(p.key for p in path)] = label
    return labels


def test_adamw_multi_conquer_multipliers_pair_with_efg_tpus():
    """Every leaf of ConQueR's tree (the tiny ConQueR of
    tests/test_torch_conquer.py) gets the same multiplier in both
    packages: efg_tpu's by its flax path, the port's through
    `flax_names`."""
    from efg_tpu.models import conquer as JCQ
    from efg_tpu.models import voxel_detr as JVD
    from efg_tpu_torch.models import conquer as TCQ
    from efg_tpu_torch.models import voxel_detr as TVD
    from efg_tpu_torch.utils.jax_import import flax_names

    from test_torch_conquer import CONTRAS_DIM, KW, _cloud

    pts, mask = _cloud(0, n=256)
    jm = JCQ.ConQueRModule(detr=JVD.VoxelDETR(**KW), contras_dim=CONTRAS_DIM, num_classes=3)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(pts),
                                            jnp.asarray(mask), False))
    cfg = {"type": "AdamWMulti", "lr_multipliers": {"backbone": 0.1, "decoder": 0.5}}
    labels = _jax_labels(cfg, shapes["params"])
    tm = TCQ.ConQueRModule(TVD.VoxelDETR(**KW, device="cpu"), contras_dim=CONTRAS_DIM)
    mults = TO.lr_multipliers(tm, cfg["lr_multipliers"])
    names = flax_names(tm)
    paired = {names[n][1]: m for (n, _), m in zip(tm.named_parameters(), mults)}
    assert set(paired) == set(labels)
    assert {p: f"m{m}" for p, m in paired.items()} == labels
    assert {0.1, 0.5, 1.0} == set(mults)


@pytest.mark.parametrize("steps", [(0, 1, 5, 9), (10, 55, 99, 100, 130)], ids=["warmup", "cosine"])
def test_linear_warmup_cosine_exact(steps):
    cfg = dict(type="LinearWarmupCosineAnnealing", lr=0.02, max_iters=100, warmup_iters=10,
               warmup_start_lr=1e-4, eta_min=1e-5)
    jf, jm = JS.build_scheduler(cfg)
    tf, tm = TS.build_scheduler(cfg)
    assert jm is None and tm is None
    for s in steps:
        want = np.float32(jf(s))
        got = tf(s)
        assert got.dtype == torch.float32 and got.item() == want, (s, got.item(), want)
