"""Port parity: the CenterPoint-VoxelNet training step (efg_tpu_torch vs
efg_tpu) on the same numpy inputs — gaussian targets, losses, the solver
(OneCycle + clip + AdamW), and the whole model's loss, gradients, BN
running statistics and three training steps under shared weights, in f32
and in the flagship's bf16."""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
import optax

from efg_tpu.models import centerpoint as JCP
from efg_tpu.modeling.backbones import rpn as JRPN
from efg_tpu.modeling.heads import center_head as JCH
from efg_tpu.ops import sparse as S
from efg_tpu.solver import optimizers as JOPT
from efg_tpu.solver import schedulers as JSCHED
from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.engine.trainer import init_state, train_step
from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.models import centerpoint as TCP
from efg_tpu_torch.modeling.heads import center_head as TCH
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.solver import optimizers as TOPT
from efg_tpu_torch.solver import schedulers as TSCHED
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_centerpoint import KW, _cloud
from test_torch_sparse_net import fill_variables

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

LOSS_CFG = dict(out_size_factor=8, gaussian_overlap=0.1, min_radius=2, max_objs=500,
                code_weights=[1.0] * 8, weight=2)  # the flagship's model.loss
MODEL_CFG = dict(pc_range=KW["pc_range"], voxel_size=KW["voxel_size"],
                 tasks=[{"num_classes": 2}, {"num_classes": 1}], common_heads=KW["common_heads"],
                 loss=LOSS_CFG)
SOLVER = dict(  # the flagship's solver, max_iters cut so that 5 steps cover warm-up
    scheduler=dict(lr=0.003, max_iters=10, pct_start=0.4, div_factor=10.0,
                   base_momentum=0.85, max_momentum=0.95),
    optimizer={"type": "AdamW", "lr": 0.003, "weight_decay": 0.01, "betas": (0.9, 0.99)},
    clip={"enabled": True, "clip_type": "norm", "params": {"max_norm": 10.0}},
)


def gt_batch(seed, bsz=2, g=24, extent=6.0):
    """GT boxes as `__graft_entry__._batch` makes them, plus the cases the
    assignment must drop: padding rows, a zero-size box, a box off the map."""
    rs = np.random.RandomState(seed)
    n = g - 4
    boxes = np.zeros((bsz, g, 9), np.float32)
    boxes[:, :n, :2] = rs.uniform(-extent * 0.9, extent * 0.9, (bsz, n, 2))
    boxes[:, :n, 2] = rs.uniform(-1.0, 1.5, (bsz, n))
    boxes[:, :n, 3:6] = rs.uniform(0.8, 5.5, (bsz, n, 3))
    boxes[:, :n, 6:8] = rs.uniform(-2, 2, (bsz, n, 2))
    boxes[:, :n, 8] = rs.uniform(-2 * np.pi, 2 * np.pi, (bsz, n))
    boxes[:, n] = boxes[:, 0]
    boxes[:, n, 3] = 0.0  # zero length
    boxes[:, n + 1] = boxes[:, 1]
    boxes[:, n + 1, 0] = extent * 3  # off the feature map
    cls = np.zeros((bsz, g), np.int32)
    cls[:, :n + 2] = rs.randint(1, 4, (bsz, n + 2))
    mask = cls > 0
    return boxes, cls, mask


def _targets_both(boxes, cls, mask, fm=(16, 16), with_vel=False):
    kw = dict(tasks=MODEL_CFG["tasks"], feature_map_size=fm, pc_range=KW["pc_range"],
              voxel_size=KW["voxel_size"], out_size_factor=8, gaussian_overlap=0.1,
              min_radius=2, with_vel=with_vel)
    want = jax.vmap(lambda b, c, m: JCH.centerpoint_targets(b, c, m, **kw))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(mask))
    got = TCH.centerpoint_targets(torch.from_numpy(boxes), torch.from_numpy(cls),
                                  torch.from_numpy(mask), **kw)
    return want, got


@pytest.mark.parametrize("with_vel", [False, True])
def test_targets_match_jax(with_vel):
    """Two tasks (classes 1-2 and 3): hm within 1e-6, anno_box within 1e-5,
    ind / mask / cat exactly."""
    want, got = _targets_both(*gt_batch(0), with_vel=with_vel)
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["hm"].numpy(), np.asarray(w["hm"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["anno_box"].numpy(), np.asarray(w["anno_box"]),
                                   rtol=1e-5, atol=1e-5)
        for k in ("ind", "mask", "cat"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
        assert g["hm"].numpy().max() == 1.0 and 0 < int(g["mask"].sum()) < g["mask"].numel() - 4


def test_losses_and_their_gradients_match_jax():
    """center_head_loss on random head maps: every entry within 1e-5
    relative, and d loss / d maps within 1e-5 · max|ref|."""
    want_t, got_t = _targets_both(*gt_batch(1))
    rs = np.random.RandomState(2)
    maps = [{k: rs.randn(2, 16, 16, n).astype(np.float32)
             for k, n in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("hm", c))}
            for c in (2, 1)]
    maps[1]["hm"][:] = -20.0  # saturated heatmap: the clip's zero-gradient side
    kw = dict(code_weights=[1.0, 0.5, 2.0, 1.0, 1.0, 1.0, 0.2, 1.0], weight=2, with_vel=False)

    def jax_total(m):
        out = JCH.center_head_loss(m, want_t, **kw)
        return out["0_loss"] + out["1_loss"], out

    (_, want), want_grad = jax.value_and_grad(jax_total, has_aux=True)(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in maps])
    tmaps = [{k: torch.from_numpy(v).requires_grad_() for k, v in t.items()} for t in maps]
    got = TCH.center_head_loss(tmaps, got_t, **kw)
    (got["0_loss"] + got["1_loss"]).backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
        assert got[k].requires_grad == (k in ("0_loss", "1_loss")), k
    for t_got, t_want in zip(tmaps, want_grad):
        for k, v in t_got.items():
            ref = np.asarray(t_want[k])
            np.testing.assert_allclose(v.grad.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max() + 1e-12, err_msg=k)


def test_one_cycle_matches_jax():
    lr_j, mom_j = JSCHED.one_cycle(**SOLVER["scheduler"])
    lr_t, mom_t = TSCHED.one_cycle(**SOLVER["scheduler"])
    for step in range(12):
        assert float(lr_t(step)) == pytest.approx(float(lr_j(step)), rel=1e-6, abs=1e-12)
        assert float(mom_t(step)) == pytest.approx(float(mom_j(step)), rel=1e-6)


def test_adamw_clip_one_cycle_match_optax():
    """5 updates on identical grads through efg_tpu's build_optimizer chain
    and the port's: parameters within 1e-6 after every step. Steps 1, 3
    and 4 clip (global norm > 10)."""
    rs = np.random.RandomState(3)
    shapes = {"kernel": (3, 4, 5), "bias": (5,), "scale": (5,), "w": (7, 2)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lr_j, mom_j = JSCHED.one_cycle(**SOLVER["scheduler"])
    tx = JOPT.build_optimizer(SOLVER["optimizer"], lr_j, mom_j, grad_clip_cfg=SOLVER["clip"])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    lr_t, mom_t = TSCHED.one_cycle(**SOLVER["scheduler"])
    ttx = TOPT.build_optimizer(SOLVER["optimizer"], lr_t, mom_t, grad_clip_cfg=SOLVER["clip"])
    names = sorted(params)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    state = ttx.init(tp)
    clipped = []
    for step, scale in enumerate((0.5, 4.0, 0.6, 9.0, 3.0)):
        grads = {k: (rs.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
        clipped.append(float(optax.global_norm(grads)) >= 10.0)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.step(tp, [torch.from_numpy(grads[k]) for k in names], state)
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{k} after step {step}")
    assert clipped == [False, True, False, True, True] and state.count == 5


def _bn_case(seed, n=64, c=8):
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, c) * 3 + 1).astype(np.float32)
    return x, rs.randn(n, c).astype(np.float32), rs.uniform(0.5, 1.5, c).astype(np.float32), \
        rs.uniform(-0.5, 0.5, c).astype(np.float32)


@pytest.mark.parametrize("masked", [True, False])
def test_batchnorm_train_mode_matches_flax(masked):
    """Train-mode BN in f32: output, d input, d scale, d bias and the
    running-stat update within 1e-5 (MaskedBatchNorm over valid rows, and
    the dense BatchNorm against flax's nn.BatchNorm on NCHW ↔ NHWC)."""
    import flax.linen as fnn

    from efg_tpu.modeling.common.norms import MaskedBatchNorm as JMBN
    from efg_tpu_torch.modeling.common.norms import BatchNorm, MaskedBatchNorm

    x, cot, scale, bias = _bn_case(6)
    mask = np.arange(x.shape[0]) % 5 != 0
    stats = {"mean": np.full(8, 0.1, np.float32), "var": np.full(8, 2.0, np.float32)}
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}
    if masked:
        jm = JMBN()
        fwd = lambda v, xx: jm.apply(v, xx, jnp.asarray(mask), False, mutable=["batch_stats"])
        tm = MaskedBatchNorm(8)
        run = lambda xx: tm(xx, torch.from_numpy(mask))
        xj, xt = x, x
    else:
        jm = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, use_running_average=False)
        fwd = lambda v, xx: jm.apply(v, xx, mutable=["batch_stats"])
        tm = BatchNorm(8)
        run = lambda xx: tm(xx).permute(0, 2, 3, 1)
        x, cot = x.reshape(4, 4, 4, 8), cot.reshape(4, 4, 4, 8)
        xj, xt = x, x.transpose(0, 3, 1, 2)
    out, new = fwd(variables, jnp.asarray(xj))
    _, vjp = jax.vjp(lambda p, xx: fwd({"params": p, "batch_stats": stats}, xx)[0],
                     variables["params"], jnp.asarray(xj))
    dp, dx = vjp(jnp.asarray(cot))
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(scale))
        tm.bias.copy_(torch.from_numpy(bias))
        tm.running_mean.fill_(0.1)
        tm.running_var.fill_(2.0)
    tm.train()
    xt = torch.from_numpy(np.ascontiguousarray(xt)).requires_grad_()
    got = run(xt)
    got.backward(torch.from_numpy(cot))
    dxt = xt.grad.numpy() if masked else xt.grad.numpy().transpose(0, 2, 3, 1)
    for g, w, what in ((got.detach().numpy(), out, "out"), (dxt, dx, "d x"),
                       (tm.weight.grad.numpy(), dp["scale"], "d scale"),
                       (tm.bias.grad.numpy(), dp["bias"], "d bias"),
                       (tm.running_mean.numpy(), new["batch_stats"]["mean"], "running mean"),
                       (tm.running_var.numpy(), new["batch_stats"]["var"], "running var")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=what)


def _train_batch(seed):
    pts, mask = _cloud(seed)
    boxes, cls, gmask = gt_batch(seed + 10)
    return dict(points=pts, points_mask=mask, gt_boxes=boxes, gt_classes=cls, gt_mask=gmask)


# Capacities above every stage's occupancy on these clouds (≤ 2900 voxels
# per sample in, ~6600 / 3800 / 900 / 480 after the four downsamples): at
# full capacity efg_tpu's XLA rule9 (`build_subm_rulebook9`,
# `_rule9_from_table`) clamps a past-the-end insertion position to cap − 1
# and gathers the δx = −1 tap from the row before the right one. Its Pallas
# rulebook and the port read the right row.
TRAIN_KW = dict(KW, max_voxels=3072, stage_caps=(8192, 6144, 2048, 1024))
# relative tolerance of (loss and its parts, grad_norm) at (step 1, steps 2-3)
STEP_TOL = {("float32", False): (1e-5, 1e-5), ("float32", True): (1e-2, 1e-1),
            ("bfloat16", False): (1e-2, 5e-2), ("bfloat16", True): (1e-1, 1e-1)}
# conv biases that feed a train-mode BN: their true gradient is zero
ZERO_GRAD = re.compile(r"(conv[012]|shared_conv)\.bias$")


class _F32Jnp:
    """`jax.numpy` with `bfloat16` read as float32: efg_tpu's RPN and
    CenterHead hard-code bf16 conv compute, and the f32 run swaps this in as
    their modules' `jnp`."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module", params=["float32"])
def jax_run(request):
    """efg_tpu's step_fn in f32 (`_jax_run`); the bfloat16 case runs in
    tests/test_torch_train_bf16.py, on another worker."""
    return _jax_run(request.param)


def _jax_run(prec):
    """efg_tpu's step_fn (trainer.py:186-222) on the XLA sparse backend, 3
    steps on 3 batches from shared weights; step 1's grads and new BN
    statistics are kept. "float32" computes every conv in f32 (the sparse
    COMPUTE_DTYPE and the dense convs' dtype switched), "bfloat16" is the
    flagship's numerics (bf16 conv inputs and trunk activations)."""
    kw = dict(TRAIN_KW, act_dtype="bfloat16" if prec == "bfloat16" else "")
    cfg = dict(MODEL_CFG, tasks=[dict(t) for t in KW["tasks"]])
    batches = [_train_batch(s) for s in (0, 1, 2)]
    with pytest.MonkeyPatch.context() as mp:
        if prec == "float32":
            mp.setattr(S, "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(JRPN, "jnp", _F32Jnp())
            mp.setattr(JCH, "jnp", _F32Jnp())
        jm = JCP.VoxelNet(sparse_backend="xla", **kw)
        b0 = batches[0]
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(b0["points"]),
                                                jnp.asarray(b0["points_mask"]), True))
        variables = fill_variables(shapes, 5)
        lr, mom = JSCHED.one_cycle(**SOLVER["scheduler"])
        tx = JOPT.build_optimizer(SOLVER["optimizer"], lr, mom, grad_clip_cfg=SOLVER["clip"])

        @jax.jit
        def step(params, batch_stats, opt_state, batch):
            def loss_fn(p):
                preds, mutated = jm.apply({"params": p, "batch_stats": batch_stats},
                                          batch["points"], batch["points_mask"], True,
                                          mutable=["batch_stats"])
                losses = JCP.compute_loss(preds, batch, model_cfg=cfg)
                return losses["loss"], (losses, mutated["batch_stats"])

            (_, (losses, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_bs, new_opt, losses, grads, \
                optax.global_norm(grads)

        params, bstats, opt_state = variables["params"], variables["batch_stats"], \
            tx.init(variables["params"])
        metrics = []
        for batch in batches:
            params, bstats, opt_state, losses, grads, gnorm = step(
                params, bstats, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in dict(losses, grad_norm=gnorm).items()})
            if len(metrics) == 1:
                first = jax.device_get({"params": grads, "batch_stats": bstats})
    return prec, kw, variables, batches, metrics, first, cfg


def _record_occupancy(tm):
    """Forward hooks noting (valid rows, capacity) of every sparse stage."""
    seen = []
    for name in ("bn_input", "bn_down1", "bn_down2", "bn_down3", "bn_extra"):
        getattr(tm.backbone, name).register_forward_hook(
            lambda m, i, o, name=name: seen.append((name, int(o.valid.sum()), o.valid.numel())))
    return seen


def test_train_steps_match_jax(jax_run, monkeypatch):
    _check_train_steps(jax_run, monkeypatch)


def _check_train_steps(jax_run, monkeypatch):
    """Three train_steps against efg_tpu's step_fn from the same weights.

    Step 1 holds the gradients. float32: both packages compute every conv
    in f32, so only summation order differs: every parameter's gradient
    within 1e-4 of its leaf's max|grad| (observed ≤ 1.2e-5); the conv
    biases that feed a train-mode BN (true gradient 0) at most 1e-5 of the
    largest gradient in both packages (observed 8e-8); the new BN running
    stats within 1e-5 of each leaf's max (observed 4e-7); the loss, its
    hm / loc parts and grad_norm within 1e-5 relative (observed 1e-6).
    bfloat16, the flagship's numerics: efg_tpu's XLA backward rounds the
    conv gradients to bf16 at other places than the port (which follows
    the Pallas backward), and train-mode BN after bf16 convs amplifies the
    difference to 40-190% of a leaf's max, so the leaves are held by
    direction: each gradient's cosine with efg_tpu's ≥ 0.5 (observed ≥
    0.75; a zeroed leaf gives 0, a negated one −1); BN stats within 1e-2 of
    each leaf's max (observed 2e-3).

    Steps 2 and 3 track the trajectory (STEP_TOL). AdamW's first updates
    move every weight by about ±lr whatever its gradient's size, so entries
    whose gradient is rounding noise move either way, and this model's
    gradients are sensitive to its weights (efg_tpu's own change by up to
    9% of a leaf's max when its weights move by 1e-5 relative). Observed:
    f32 loss parts ≤ 3.3e-3 and grad_norm ≤ 2.9e-2; bf16 ≤ 3.8e-3 and
    1.5e-2 at step 1, ≤ 4.8e-2 and 5.2e-2 after. The sparse VJPs are held
    at 1e-4 by test_torch_sparse_backward.py, train-mode BN at 1e-5 above."""
    prec, kw, variables, batches, want, want_g, cfg = jax_run
    f32 = prec == "float32"
    tm = TCP.VoxelNet(device="cpu", **kw)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    if f32:
        monkeypatch.setattr(K, "COMPUTE_DTYPE", torch.float32)
        for m in tm.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                m.dtype = None
    occupancy = _record_occupancy(tm)
    md = ModelDef(tm, lambda b: dict(points=b["points"], points_mask=b["points_mask"]),
                  loss_fn=lambda preds, b: TCP.compute_loss(preds, b, model_cfg=cfg))
    lr, mom = TSCHED.one_cycle(**SOLVER["scheduler"])
    tx = TOPT.build_optimizer(SOLVER["optimizer"], lr, mom, grad_clip_cfg=SOLVER["clip"])
    state = init_state(md, tx)
    got = []
    for i, batch in enumerate(batches):
        m = train_step(md, tx, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got.append({k: float(v) for k, v in m.items()})
        if i > 0:
            continue
        ref = flax_to_state_dict(tm, want_g)
        names = {n for n, _ in tm.named_parameters()} | {n for n, _ in tm.named_buffers()}
        assert names == set(ref)
        for n, b in tm.named_buffers():
            r = ref[n].numpy()
            np.testing.assert_allclose(b.numpy(), r, rtol=0, atol=(1e-5 if f32 else 1e-2) *
                                       np.abs(r).max(), err_msg=n)
        top = max(float(np.abs(ref[n].numpy()).max()) for n, _ in tm.named_parameters())
        zero = [n for n, _ in tm.named_parameters() if ZERO_GRAD.search(n)]
        assert len(zero) == 22
        for n, p in tm.named_parameters():
            r = ref[n].numpy()
            g = np.zeros_like(r) if p.grad is None else p.grad.numpy()
            if ZERO_GRAD.search(n):
                if f32:
                    assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-5 * top, n
            elif f32:
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=n)
            else:
                cos = float((g * r).sum() / max(np.linalg.norm(g) * np.linalg.norm(r), 1e-30))
                assert cos >= 0.5, (n, cos)
    assert all(n < cap for _, n, cap in occupancy), occupancy
    assert state.step == 3 and state.opt_state.count == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in ("loss", "0_hm_loss", "0_loc_loss", "grad_norm"):
            rel = STEP_TOL[prec, i > 0][k == "grad_norm"]
            assert g[k] == pytest.approx(w[k], rel=rel), (i, k, g[k], w[k])
        assert g["0_num_positive"] == w["0_num_positive"] > 0
    assert got[2]["loss"] < got[0]["loss"]
    assert not any(K.launches.values())
