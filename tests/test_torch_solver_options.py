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
ConQueR's whole tree. The schedule is exact in f32.
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
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

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


def _run(cfg, clip=None, tol=1e-6):
    """STEPS updates of the same gradients through both packages; each leaf
    within `tol` of its max after every step."""
    params = _tree(0)
    grads = [_tree(10 + k, scale=3.0) for k in range(STEPS)]
    jtx = JO.build_optimizer(cfg, _lr, grad_clip_cfg=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    ttx = TO.build_optimizer(cfg, _lr_t, grad_clip_cfg=clip)
    names = sorted(SHAPES)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
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
