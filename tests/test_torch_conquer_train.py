"""Port parity: ConQueR / Voxel-DETR training at a tiny size (efg_tpu_torch
vs efg_tpu), on the CPU.

The pieces on random inputs: the box coder's `encode`, axis-aligned GIoU3D,
the focal loss and the matcher's cost at 1e-6; the Hungarian assignment
equal as integers; `prepare_cdn` bit for bit under efg_tpu's own draws
(`jax.random.split(rng, 4)`, then `uniform` / `randint`, handed to the port
as `noise_override`); `compute_loss`, `dn_loss` and `query_contrast_loss`
part by part; the window ops' gradients against `jax.vjp` of efg_tpu's
(the gather op's custom VJP `_window_gather_runs` and the dense op).

The whole step: `tests/test_torch_conquer.py`'s tiny ConQueR (hidden 32, 1
encoder and 2 decoder layers, 16 queries, its clustered 1024-point clouds)
with 6 GT slots a sample (4 and 3 valid) and 2 denoising groups, efg_tpu's
variables from `jax.eval_shape` and numpy, trained two steps by a
hand-composed efg_tpu step as bench.py's (`custom_loss`, clip 10 + AdamW
1e-3, `ema_update`) under one `jax.jit`, and by the port's `train_step`
with efg_tpu's noise for each step. Both run in f32: the sparse convs
(`sparse.set_compute_dtype`, `K.COMPUTE_DTYPE`) and the window ops, whose
bf16 roundings are swapped for efg_tpu's f32 forms of the same functions
(`box_attention_window_dense`, the gather's `runs=False`) and the port's
`WINDOW_DTYPE` / `GATHER_DOT_DTYPE`; a rounding flip there would move the
gradients of every layer before it by bf16 steps.
"""

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
import optax

from efg_tpu.geometry import box_ops_jnp as JBOX
from efg_tpu.models import conquer as JCQ
from efg_tpu.models import voxel_detr as JVD
from efg_tpu.ops import box_attention as JBA
from efg_tpu.ops import matcher as JM
from efg_tpu.ops import sparse as JS
from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.engine.trainer import init_state, train_step
from efg_tpu_torch.geometry import box_ops_torch as TBOX
from efg_tpu_torch.models import conquer as TCQ
from efg_tpu_torch.models import voxel_detr as TVD
from efg_tpu_torch.ops import box_attention as TBA
from efg_tpu_torch.ops import matcher as TM
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.solver.optimizers import AdamW
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_conquer import CONTRAS_DIM, KW, _cloud
from test_torch_conquer_ops import _close, fill_variables

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

MW = {"class": 1.0, "bbox": 4.0, "giou": 2.0, "rad": 4.0}
DN = dict(dn_number=2, dn_box_noise_scale=0.4, dn_label_noise_ratio=0.5)
CFG = dict(pc_range=KW["pc_range"], voxel_size=KW["voxel_size"], loss_weights=MW, dn=DN,
           contrastive=dict(mom=0.999, dim=CONTRAS_DIM, eqco=1000, tau=0.7, loss_coeff=0.2))
G = 6  # GT slots a sample
# The weights' seed. Seed 11 put one input of the encoder's FFN ReLU at
# 6.7e-8, inside the packages' forward difference of the kink: its
# derivative flipped and moved the trunk's gradients by up to 2e-2 of a
# leaf. Under this seed the whole model agrees to 2e-5.
WEIGHT_SEED = 12
PIECE_TOL = 1e-6  # f32 elementwise formulas: a last-bit difference
LOSS_TOL = 1e-5  # relative, loss parts (f32 sums in another order)
GRAD_TOL = 1e-4  # of each leaf's max|grad|


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gt(seed, n_valid=(4, 3)):
    """GT boxes [2, G, 9] over the tiny model's ±8 m (raw, yaw in ±π),
    classes 1-3 and the mask; slots past n_valid are padding."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((2, G, 9), np.float32)
    cls = np.zeros((2, G), np.int32)
    for b, n in enumerate(n_valid):
        gt[b, :n, :2] = rs.uniform(-6.5, 6.5, (n, 2))
        gt[b, :n, 2] = rs.uniform(-1.0, 1.5, n)
        gt[b, :n, 3:6] = rs.uniform(0.6, 4.0, (n, 3))
        gt[b, :n, 8] = rs.uniform(-np.pi, np.pi, n)
        cls[b, :n] = rs.randint(1, 4, n)
    return gt, cls, cls > 0


def _batch(step):
    pts, mask = _cloud(step)
    gt, cls, gm = _gt(20 + step)
    return dict(points=pts, points_mask=mask, gt_boxes=gt, gt_classes=cls, gt_mask=gm)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _draws(rng, b, p, num_classes, label_noise_ratio):
    k_lbl, k_box, k_sign, k_flip = jax.random.split(rng, 4)
    return dict(
        flip=jax.random.uniform(k_flip, (b, p)) < (label_noise_ratio * 0.5),
        rand_lbl=jax.random.randint(k_lbl, (b, p), 0, num_classes),
        sign=jax.random.randint(k_sign, (b, p, 7), 0, 2).astype(jnp.float32) * 2 - 1,
        rand=jax.random.uniform(k_box, (b, p, 7)))


def jax_noise(rng, b, p, num_classes, label_noise_ratio):
    """efg_tpu's prepare_cdn draws (its conquer.py:90-116), as numpy."""
    return jax.tree_util.tree_map(np.asarray, _draws(rng, b, p, num_classes, label_noise_ratio))


def _torch_noise(noise):
    return {k: _t(v) for k, v in noise.items()}


def _rel(got, want):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    return abs(got - want) / max(abs(want), 1e-12)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("piece", ["encode", "giou", "focal", "match_cost"])
def test_loss_pieces_match(piece):
    """Each piece against efg_tpu's at 1e-6 of its scale."""
    rs = np.random.RandomState(3)
    if piece == "encode":
        gt = np.concatenate([rs.uniform(-9, 9, (2, 5, 3)), rs.uniform(0.5, 5, (2, 5, 3)),
                             rs.randn(2, 5, 2), rs.uniform(-7, 7, (2, 5, 1))], -1).astype(np.float32)
        coder = (TVD.VoxelBoxCoder3D(KW["voxel_size"], KW["pc_range"]),
                 JVD.VoxelBoxCoder3D(KW["voxel_size"], KW["pc_range"]))
        _close(coder[0].encode(_t(gt)), coder[1].encode(jnp.asarray(gt)), PIECE_TOL, piece)
        _close(TBOX.limit_period(_t(gt[..., 8]), 0.5, 2 * np.pi),
               JBOX.limit_period(jnp.asarray(gt[..., 8]), 0.5, 2 * np.pi), PIECE_TOL, "limit")
        return
    a = np.concatenate([rs.uniform(0.2, 0.8, (9, 3)), rs.uniform(0.02, 0.3, (9, 3)),
                        rs.rand(9, 1)], -1).astype(np.float32)
    b = np.concatenate([a[:5, :3] + rs.randn(5, 3) * 0.05, rs.uniform(0.02, 0.3, (5, 3)),
                        rs.rand(5, 1)], -1).astype(np.float32)
    if piece == "giou":
        want = JBOX.aligned_giou_3d(jnp.asarray(a), jnp.asarray(b))
        _close(TBOX.aligned_giou_3d(_t(a), _t(b)), want, PIECE_TOL, piece)
        _close(TBOX.aligned_iou_3d(_t(a), _t(b)), JBOX.aligned_iou_3d(jnp.asarray(a),
                                                                      jnp.asarray(b)), PIECE_TOL)
        _close(TBOX.aligned_giou_3d_pairs(_t(a[:5]), _t(b)), np.diagonal(np.asarray(want)),
               PIECE_TOL, "diagonal")
        assert float(np.abs(want).max()) > 0.1
    elif piece == "focal":
        logits = (rs.randn(4, 7, 3) * 4).astype(np.float32)
        tgt = (rs.rand(4, 7, 3) < 0.3).astype(np.float32)
        _close(TVD.sigmoid_focal_loss(_t(logits), _t(tgt)),
               JVD.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(tgt)), PIECE_TOL, piece)
    else:
        logits = (rs.randn(9, 3) * 2).astype(np.float32)
        labels = rs.randint(0, 3, 5).astype(np.int32)
        mask = np.array([1, 1, 0, 1, 0], bool)
        want = JVD.match_cost(jnp.asarray(logits), jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(labels), jnp.asarray(mask), MW)
        got = TVD.match_cost(_t(logits), _t(a), _t(b), _t(labels), _t(mask), MW)
        np.testing.assert_array_equal(got.numpy()[:, ~mask], 1e8)
        _close(got[:, mask], np.asarray(want)[:, mask], PIECE_TOL, piece)


@pytest.mark.parametrize("case", ["random", "hazards"])
def test_matcher_assignments_equal(case):
    """[B, Q, G] costs with masked GT columns (a sample without any valid
    GT; nan and ±inf entries in "hazards"): the port's assignment equals
    efg_tpu's host solver's, as integers, with −1 at padding."""
    rs = np.random.RandomState(4)
    cost = rs.randn(3, 12, 7).astype(np.float32)
    mask = rs.rand(3, 7) < 0.7
    mask[1] = False
    if case == "hazards":
        cost[0, 2, 1], cost[2, 5, 3], cost[2, 7, 0] = np.nan, np.inf, -np.inf
    want = np.asarray(JM.hungarian_match(jnp.asarray(cost), jnp.asarray(mask), backend="host"))
    got = TM.hungarian_match(_t(cost), _t(mask))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~mask] == -1).all() and (want[mask] >= 0).all()


@pytest.mark.parametrize("case", ["edges", "padding"])
def test_prepare_cdn_bit_for_bit(case):
    """efg_tpu's prepare_cdn from an rng against the port's fed the same
    draws: dn_ref, the attention mask and the validity, bit for bit; boxes
    near the map's edges, so the clip acts, or a sample without any valid
    GT. efg_tpu runs op by op here: under jit XLA contracts `corner +
    noise` into fused multiply-adds, which moves 3% of the entries by a
    last bit. Both cases have one shape, so efg_tpu's ops compile once."""
    dn_number = DN["dn_number"]
    gt, cls, gm = _gt(5, n_valid=(4, 3) if case == "edges" else (5, 0))
    boxes = TVD.VoxelBoxCoder3D(KW["voxel_size"], KW["pc_range"]).encode(_t(gt)).numpy()
    if case == "edges":
        boxes[0, 0, :2] = (0.01, 0.99)
    labels = np.clip(cls - 1, 0, None)
    rng = jax.random.fold_in(jax.random.key(7), 0 if case == "edges" else 1)
    kw = dict(dn_number=dn_number, label_noise_ratio=0.5, box_noise_scale=0.4, num_classes=3,
              num_queries=16)
    want = JCQ.prepare_cdn(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(gm), rng, **kw)
    noise = jax_noise(rng, 2, 2 * G * dn_number, 3, 0.5)
    got = TCQ.prepare_cdn(_t(boxes), _t(labels).long(), _t(gm), None, **kw,
                          noise_override=_torch_noise(noise))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert got[0].shape == (2, 2 * G * dn_number, 10) and noise["flip"].any()
    assert (np.asarray(want[0])[1] == 0).all() == (case == "padding")
    if case == "edges":  # the clip acts
        assert ((np.asarray(want[0])[0, :, :7] == 0) | (np.asarray(want[0])[0, :, :7] == 1)).any()


def _random_preds(rs, d=2, b=2, q=16, lcells=100, c=3):
    topk = np.stack([rs.permutation(lcells)[:q] for _ in range(b)]).astype(np.int32)
    return dict(enc_logits=rs.randn(b, lcells, 1).astype(np.float32) * 2,
                enc_boxes=rs.uniform(0.05, 0.95, (b, lcells, 7)).astype(np.float32),
                topk_idx=topk,
                dec_logits=rs.randn(d, b, q, c).astype(np.float32) * 2,
                dec_boxes=rs.uniform(0.05, 0.95, (d, b, q, 7)).astype(np.float32))


def _proj_params(rs, cin, dim):
    return {f"fc{i}": {"kernel": (rs.randn(a, dim) / np.sqrt(a)).astype(np.float32),
                       "bias": rs.uniform(-0.2, 0.2, dim).astype(np.float32)}
            for i, a in enumerate((cin, dim))}


def _torch_proj(params):
    m = TCQ._ProjMLP(params["fc0"]["kernel"].shape[0], params["fc0"]["kernel"].shape[1])
    with torch.no_grad():
        for i in (0, 1):
            lin = getattr(m, f"fc{i}")
            lin.weight.copy_(_t(params[f"fc{i}"]["kernel"].T))
            lin.bias.copy_(_t(params[f"fc{i}"]["bias"]))
    return m


@pytest.mark.parametrize("loss", ["compute_loss", "dn_loss", "query_contrast_loss"])
def test_losses_match(loss):
    """Each loss on random predictions, every part within 1e-5 relative
    (compute_loss: its 1 + D layers' assignments equal, and the last
    layer's, which `return_assign` hands to the contrast loss)."""
    rs = np.random.RandomState(6)
    gt, cls, gm = _gt(8)
    batch = dict(gt_boxes=gt, gt_classes=cls, gt_mask=gm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    if loss == "compute_loss":
        preds = _random_preds(rs)
        want, want_a = jax.jit(functools.partial(JVD.compute_loss, model_cfg=CFG,
                                                 return_assign=True))(
            {k: jnp.asarray(v) for k, v in preds.items()}, jb)
        got, got_a = TVD.compute_loss({k: _t(v).long() if k == "topk_idx" else _t(v)
                                       for k, v in preds.items()}, tb, model_cfg=CFG,
                                      return_assign=True)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    elif loss == "dn_loss":
        p = 2 * G * 2
        logits = rs.randn(2, 2, p, 3).astype(np.float32) * 2
        boxes = rs.uniform(0.05, 0.95, (2, 2, p, 7)).astype(np.float32)
        tgt = np.asarray(JVD.VoxelBoxCoder3D(KW["voxel_size"], KW["pc_range"]).encode(jb["gt_boxes"]))
        labels, n = np.clip(cls - 1, 0, None), np.float32(max(gm.sum(), 1))
        want = jax.jit(functools.partial(JCQ.dn_loss, mw=MW, dn_number=2))(
            jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(tgt), jnp.asarray(labels),
            jb["gt_mask"], jnp.asarray(n))
        got = TCQ.dn_loss(_t(logits), _t(boxes), _t(tgt), _t(labels).long(), tb["gt_mask"],
                          torch.tensor(n), MW, 2)
    else:
        q, lgt, dim = 16, 3 * G, CONTRAS_DIM
        pl, pb = rs.randn(2, q, 3).astype(np.float32), rs.rand(2, q, 7).astype(np.float32)
        gl, gb = rs.randn(2, lgt, 3).astype(np.float32), rs.rand(2, lgt, 7).astype(np.float32)
        assign = np.where(gm, np.stack([rs.permutation(q)[:G] for _ in range(2)]), -1)
        pp, pq = _proj_params(rs, 10, dim), _proj_params(rs, dim, dim)
        w = jax.jit(functools.partial(
            JCQ.query_contrast_loss, projector=JCQ._ProjMLP(dim), predictor=JCQ._ProjMLP(dim),
            tau=0.7, dn_number=2))(*(jnp.asarray(a) for a in (pl, pb, gl, gb, assign)),
                                   jb["gt_mask"], params_proj=pp, params_pred=pq)
        g_ = TCQ.query_contrast_loss(*(_t(a) for a in (pl, pb, gl, gb)), _t(assign).long(),
                                     tb["gt_mask"], projector=_torch_proj(pp),
                                     predictor=_torch_proj(pq), tau=0.7, dn_number=2)
        want, got = {"contrast": w}, {"contrast": g_}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= LOSS_TOL, (k, float(got[k]), float(want[k]))
        assert np.isfinite(float(want[k]))


@pytest.mark.parametrize("op", ["gather", "dense_bf16", "dense_f32"])
def test_window_op_gradients_match(op):
    """The window ops' outputs and gradients (dV, dA) from the port's
    autograd against `jax.vjp` of efg_tpu's ops on a 9×11 map, 4 heads,
    radius 2. gather: the decoder's op, efg_tpu's custom VJP (f32 sums; A
    in f32, its CPU `_dot_dtype`) at 1e-5 of each max. dense_bf16: the
    encoder's op as the model runs it (efg_tpu's tile-local
    `box_attention_window_dense_mxu`, whose autodiff rounds dV and dA to
    bf16 per tile and adds the tiles' halos in bf16; the port rounds each
    once) at 1e-2. dense_f32: WINDOW_DTYPE f32 against efg_tpu's f32
    `box_attention_window_dense` at 1e-5."""
    rs = np.random.RandomState(9)
    b, h, w, c, nh, r = 2, 9, 11, 16, 4, 2
    s2 = (2 * r + 1) ** 2
    value = rs.randn(b, h, w, c).astype(np.float32)
    if op == "gather":
        l = 7
        base = np.stack([rs.randint(0, h, (b, l)), rs.randint(0, w, (b, l))], -1).astype(np.int32)
        base[0, 0], base[1, 1] = (0, 0), (h - 1, w - 1)  # windows over both corners
        jf = functools.partial(JBA.box_attention_window_gather, base_yx=jnp.asarray(base),
                               num_heads=nh, radius=r, chunk=4)
        tf = functools.partial(TBA.box_attention_window_gather, base_yx=_t(base), num_heads=nh,
                               radius=r, chunk=4)
        tol, dtypes = 1e-5, dict(GATHER_DOT_DTYPE=torch.float32)
    else:
        l = h * w
        f32 = op == "dense_f32"
        jop = JBA.box_attention_window_dense if f32 else JBA.box_attention_window_dense_mxu
        jf = functools.partial(jop, num_heads=nh, radius=r)
        tf = functools.partial(TBA.box_attention_window_dense, num_heads=nh, radius=r)
        tol, dtypes = (1e-5, dict(WINDOW_DTYPE=torch.float32)) if f32 else (1e-2, {})
    coeffs = rs.rand(b, l, nh, s2).astype(np.float32) / s2
    cot = rs.randn(b, l, c).astype(np.float32)
    @jax.jit
    def fwd_bwd(v, a, g):
        out, vjp = jax.vjp(jf, v, a)
        return (out,) + vjp(g)

    out_j, dv_j, da_j = fwd_bwd(jnp.asarray(value), jnp.asarray(coeffs), jnp.asarray(cot))
    vt, at = _t(value).requires_grad_(), _t(coeffs).requires_grad_()
    saved = {k: getattr(TBA, k) for k in dtypes}
    try:
        for k, v in dtypes.items():
            setattr(TBA, k, v)
        out_t = tf(vt, at)
        out_t.backward(_t(cot))
    finally:
        for k, v in saved.items():
            setattr(TBA, k, v)
    _close(out_t, out_j, tol if op != "dense_bf16" else 1e-5, "out")
    _close(vt.grad, dv_j, tol, "dV")
    _close(at.grad, da_j, tol, "dA")


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def steps():
    """Two f32 training steps of each package from the same variables
    (efg_tpu: one jitted step function called twice), with step 1's
    losses and gradients, the parameters and EMA after each step, and
    efg_tpu's noise draws of each step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    batches = [_batch(i) for i in (0, 1)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBA, "box_attention_window_dense_mxu", JBA.box_attention_window_dense)
        mp.setattr(JBA, "box_attention_window_gather",
                   functools.partial(JBA.box_attention_window_gather, runs=False))
        JS.set_compute_dtype(jnp.float32)
        try:
            jmd = JCQ.make_model_def(KW, CFG)
            jb = [{k: jnp.asarray(v) for k, v in bt.items()} for bt in batches]
            shapes = jax.eval_shape(lambda: jmd.module.init(
                jax.random.key(0), jb[0]["points"], jb[0]["points_mask"], True))
            variables = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, WEIGHT_SEED))
            tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(1e-3))

            @jax.jit
            def step(params, bstats, opt, ema, batch, i):
                rng = jax.random.fold_in(jax.random.key(0), i)

                def loss_fn(p):
                    loss, losses, new_bs = jmd.custom_loss(jmd.module, p, bstats, ema, batch, rng)
                    return loss, (losses, new_bs)

                (_, (losses, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
                updates, opt = tx.update(grads, opt, params)
                params = optax.apply_updates(params, updates)
                return params, new_bs, opt, jmd.ema_update(ema, params), losses, grads

            params, bstats = variables["params"], variables["batch_stats"]
            opt, ema = jax.jit(lambda p: (tx.init(p), jmd.ema_init(p)))(params)
            want = []
            for i, batch in enumerate(jb):
                params, bstats, opt, ema, losses, grads = step(params, bstats, opt, ema, batch, i)
                want.append(jax.device_get(dict(losses=losses, grads=grads, params=params,
                                                ema=ema)))
        finally:
            JS.set_compute_dtype(jnp.bfloat16)
    p = 2 * G * DN["dn_number"]
    noise = [jax_noise(jax.random.fold_in(jax.random.key(0), i), 2, p, 3, 0.5) for i in (0, 1)]

    tmd = TCQ.make_model_def(KW, CFG, device="cpu")
    tm = tmd.module
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    state_box = {}

    def custom_loss(mod, ema_, batch, gen):
        return TCQ.conquer_train_loss(mod, ema_, batch, gen, model_cfg=CFG,
                                      noise_override=_torch_noise(noise[state_box["s"].step]))

    md = ModelDef(tm, tmd.apply_args, tmd.loss_fn, tmd.predict_fn, custom_loss=custom_loss,
                  ema_init=tmd.ema_init, ema_update=tmd.ema_update)
    tx_t = AdamW(lr_schedule=lambda k: 1e-3, weight_decay=1e-4, betas=(0.9, 0.999), eps=1e-8,
                 max_norm=10.0)
    old = K.COMPUTE_DTYPE, TBA.WINDOW_DTYPE, TBA.GATHER_DOT_DTYPE
    K.COMPUTE_DTYPE = TBA.WINDOW_DTYPE = TBA.GATHER_DOT_DTYPE = torch.float32
    try:
        state = state_box["s"] = init_state(md, tx_t)
        got = []
        for batch in batches:
            ema_before = {k: v.clone() for k, v in state.ema.items()}
            m = train_step(md, tx_t, state, {k: _t(v) for k, v in batch.items()})
            got.append(dict(losses={k: float(v) for k, v in m.items()},
                            grads={n: (torch.zeros_like(q) if q.grad is None else q.grad.clone())
                                   for n, q in tm.named_parameters()},
                            params={n: q.detach().clone() for n, q in tm.named_parameters()},
                            ema={k: v.clone() for k, v in state.ema.items()},
                            ema_before=ema_before))
    finally:
        K.COMPUTE_DTYPE, TBA.WINDOW_DTYPE, TBA.GATHER_DOT_DTYPE = old
        torch.set_num_threads(n)
    yield dict(want=want, got=got, variables=variables, tm=tm, state=state)


def _torch_names(tm, variables, tree):
    """A flax params tree (grads, parameters) by the port's parameter names."""
    sd = flax_to_state_dict(tm, {"params": tree, "batch_stats": variables["batch_stats"]})
    return {n: sd[n] for n, _ in tm.named_parameters()}


def test_train_loss_parts_match(steps):
    """Step 1's loss and its 22 parts (the encoder's and 2 decoder layers'
    set losses, 2 layers of denoising losses, 2 of query contrast) within
    1e-5 relative; the port's grad_norm too."""
    got, want = steps["got"][0]["losses"], steps["want"][0]["losses"]
    assert set(got) == set(want) | {"grad_norm"} and len(want) == 23
    for k in want:
        assert _rel(got[k], want[k]) <= LOSS_TOL, (k, got[k], float(want[k]))
    gn = float(optax.global_norm(steps["want"][0]["grads"]))
    assert _rel(got["grad_norm"], gn) <= LOSS_TOL


# leaves whose gradient is 0 or nearly: conv and projection biases that a
# train-mode BN or a GroupNorm follows, the attention key biases (a softmax
# is blind to a shift of its logits), and the bias of the FPN's res3 output
# norm (p3's input projection and GroupNorm leave it 1e-7 of the largest)
ZERO_GRAD = re.compile(r"(\.b1\.conv[12]\.bias|input_proj_p3\.bias|output_res3_norm\.bias|"
                       r"self_attn\.key\.bias)$")


def test_step1_gradients_match(steps):
    """Every parameter's step-1 gradient within 1e-4 of its leaf's
    max|grad| (observed 2e-5); the leaves whose true gradient is 0
    (ZERO_GRAD, and res2's FPN path, which p3 does not use) at most 1e-5
    of the largest gradient in both packages. The contrastive projector
    learns from both branches, the predictor from the query branch."""
    got = steps["got"][0]["grads"]
    want = _torch_names(steps["tm"], steps["variables"], steps["want"][0]["grads"])
    assert set(got) == set(want)
    top = max(float(r.abs().max()) for r in want.values())
    zero = [n for n in got if ZERO_GRAD.search(n)]
    assert len(zero) == 10, zero
    for n, g in got.items():
        r = want[n].numpy()
        if n in zero:
            assert max(float(g.abs().max()), float(np.abs(r).max())) <= 1e-5 * top, n
            continue
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=n)
    for n in ("projector.fc0.weight", "predictor.fc1.weight", "detr.decoder.dec1.cross_attn."
              "value_proj.weight", "detr.backbone.stem_conv1.weight"):
        assert float(got[n].abs().max()) > 0, n


def test_two_steps_params_and_ema_match(steps):
    """Two steps of clip + AdamW + EMA against efg_tpu's. AdamW's first
    steps move each weight by about ±lr whatever its gradient's size, so
    the leaves whose gradient is rounding noise (ZERO_GRAD) move in no
    agreed direction, and step 1's last-bit differences reach step 2's
    forward (its loss parts agree to 9e-5 relative, held at 1e-3). So:
    every weight within 2.5·lr a step of efg_tpu's; per leaf outside
    ZERO_GRAD, the update since the start points the same way (cosine
    ≥ 0.999 after step 1, observed 0.99991; ≥ 0.99 after step 2, observed
    0.9937). The EMA decoder is e·mom + p·(1 − mom) of the port's own
    tensors, bit for bit, and within (1 − mom) of the parameters'
    difference of efg_tpu's (+ two f32 roundings)."""
    mom = CFG["contrastive"]["mom"]
    tm, variables = steps["tm"], steps["variables"]
    init = _torch_names(tm, variables, variables["params"])
    for k, v in steps["want"][1]["losses"].items():
        assert _rel(steps["got"][1]["losses"][k], v) <= 1e-3, k
    for i, (got, want) in enumerate(zip(steps["got"], steps["want"])):
        wp = _torch_names(tm, variables, want["params"])
        for n in wp:
            d = float((got["params"][n] - wp[n]).abs().max())
            assert d <= 2.5e-3 * (i + 1), (i, n, d)
            if ZERO_GRAD.search(n):
                continue
            a, b = ((x - init[n]).double().flatten() for x in (got["params"][n], wp[n]))
            cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
            assert cos >= (0.999, 0.99)[i], (i, n, cos)
        wema = flax_to_state_dict(tm.detr.decoder, {"params": want["ema"]["decoder"]})
        assert set(got["ema"]) == set(wema) and len(wema) > 0
        for n, e in got["ema"].items():
            p = got["params"][f"detr.decoder.{n}"]
            assert torch.equal(e, got["ema_before"][n] * mom + p * (1.0 - mom)), n
            dp = float((p - wp[f"detr.decoder.{n}"]).abs().max())
            de = float((e - wema[n]).abs().max())
            assert de <= (1 - mom) * dp + 2.4e-7 * max(1.0, float(e.abs().max())), (i, n, de, dp)
    assert steps["state"].step == 2
