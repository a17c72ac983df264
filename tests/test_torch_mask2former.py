"""Port parity of Mask2Former as a whole model (efg_tpu_torch vs efg_tpu) at
a tiny size: R-18 trunk (FrozenBN, freeze_at 0), 64×64 images, batch 2,
d_model 32, 8 queries, 3 decoder layers, 4 classes, 256 points, f32.

efg_tpu's variables come from `jax.eval_shape` of its init with every
leaf drawn from a numpy seed (`fill_variables`) and are carried into the
port by `utils/jax_import.py`. One jitted efg_tpu call gives the train
forward, `compute_loss` under `jax.random.key(7)` and every layer's
assignment, with ReLU and with every ReLU a GELU (`lower_smooth`); the
port's `compute_loss` is handed efg_tpu's draws (the shared points
`uniform(rng)`, and per layer the candidate and top-up points of
`split(fold_in(rng, li + 1))`):

- cls and mask logits of every layer within 1e-4 of each output's max;
- the masked attention's bits (each layer's mask logits resized to its
  scale, sigmoid > 0.5) equal wherever efg_tpu's pre-threshold value
  lies more than 1e-6 from 0.5; the count of those that do not is
  asserted (0 on this seed);
- every layer's Hungarian assignment equal (efg_tpu's `matcher_cost` and
  `hungarian_match`, jitted);
- every loss term within 1e-5 relative;
- the port's Swin-trunk Mask2Former builds and runs (shapes).

The step-1 gradients are held in `test_torch_mask2former_grads.py`, with
a compile of their own, so that neither file keeps a test worker long.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.models import mask2former as JM
from efg_tpu.ops.matcher import hungarian_match as j_hungarian
from efg_tpu_torch.models import mask2former as TM
from efg_tpu_torch.ops.resize import resize
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_conquer_ops import fill_variables

CFG = dict(num_classes=4, num_points=256, class_weight=2.0, mask_weight=5.0, dice_weight=5.0,
           no_object_weight=0.1, oversample_ratio=3.0, importance_sample_ratio=0.75)
MODEL = dict(num_classes=4, num_queries=8, d_model=32, dec_layers=3, depth=18, freeze_at=0)
OUT_TOL = 1e-4
LOSS_TOL = 1e-5
BAND = 1e-6  # attention-mask bits are compared outside |σ − 0.5| ≤ BAND
SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def m2f_batch(seed=0, bsz=2, size=64, g=4):
    """Images and 1-3 rectangle masks an image at 1/4 scale, padded to g."""
    rs = np.random.RandomState(seed)
    imgs = rs.uniform(-1, 1, (bsz, size, size, 3)).astype(np.float32)
    hm = size // 4
    masks = np.zeros((bsz, g, hm, hm), np.float32)
    classes = np.zeros((bsz, g), np.int32)
    valid = np.zeros((bsz, g), bool)
    for b in range(bsz):
        for i in range(rs.randint(1, 4)):
            x0, y0 = rs.randint(0, hm - 4, 2)
            w, h = rs.randint(3, 8, 2)
            masks[b, i, y0:y0 + h, x0:x0 + w] = 1.0
            classes[b, i] = rs.randint(0, 4)
            valid[b, i] = True
    return dict(images=imgs, gt_masks=masks, gt_classes_seg=classes, gt_mask_valid=valid)


def jax_draws(rng, b, g, num_points):
    """efg_tpu's draws in `compute_loss` under `rng`, for 4 layers."""
    n_over = int(num_points * CFG["oversample_ratio"])
    n_rand = num_points - int(num_points * CFG["importance_sample_ratio"])
    pts = np.asarray(jax.random.uniform(rng, (num_points, 2)))
    cand, rand = [], []
    for li in range(MODEL["dec_layers"] + 1):
        r1, r2 = jax.random.split(jax.random.fold_in(rng, li + 1))
        cand.append(torch.from_numpy(np.array(jax.random.uniform(r1, (b, g, n_over, 2)))))
        rand.append(torch.from_numpy(np.array(jax.random.uniform(r2, (b * g, n_rand, 2)))))
    return torch.from_numpy(np.array(pts)), cand, rand


def _port_run(variables, batch, draws, smooth):
    """The port's train forward, `compute_loss` on efg_tpu's draws and
    backward, from efg_tpu's variables; `smooth` makes every ReLU a GELU
    (erf form)."""
    tm = TM.Mask2Former(**MODEL, device="cpu")
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    tm.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    relu = torch.relu
    if smooth:
        torch.relu = torch.nn.functional.gelu
    try:
        preds = tm(tb["images"])
        pts, cand, rand = draws
        losses = TM.compute_loss(preds, tb, model_cfg=CFG, points=pts, cand=cand,
                                 rand_points=rand)
        losses["loss"].backward()
    finally:
        torch.relu = relu
    assign = TM.match_layers(preds["cls_logits"], preds["mask_logits"],
                             tb["gt_classes_seg"].long(), TM.sample_points(tb["gt_masks"], pts),
                             tb["gt_mask_valid"], pts, w_ce=2.0, w_bce=5.0, w_dice=5.0)
    return dict(tm=tm, preds={k: v.detach() for k, v in preds.items()},
                losses={k: float(v.detach()) for k, v in losses.items()}, assign=assign)


def jax_setup():
    """The batch (numpy and jnp), efg_tpu's Mask2Former and its variables
    drawn from a numpy seed."""
    batch = m2f_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JM.Mask2Former(**MODEL)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jbatch["images"], True))
    return batch, jbatch, jm, jax.tree_util.tree_map(np.asarray, fill_variables(shapes, 5))


def lower_smooth(fn, *args):
    """`fn(*args)` compiled once as `f(*args, smooth)`: every `jax.nn.relu`
    efg_tpu calls is a GELU (erf form) where the traced flag `smooth` is
    true, so the ReLU and the GELU runs share one compile. LLVM's
    optimisation passes take a third of the compile and nothing of the
    values (the XLA passes still run)."""
    relu = jax.nn.relu
    flag = [False]

    def act(x):
        return jnp.where(flag[0], jax.nn.gelu(x, approximate=False), relu(x))

    def flagged(*a):
        flag[:] = [a[-1]]
        return fn(*a[:-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "relu", act)
        return jax.jit(flagged).lower(*args, jnp.asarray(False)).compile(
            compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def m2f():
    """efg_tpu's training forward, loss and assignments as one compiled
    call, run with ReLU and with every ReLU a GELU, and the port's two
    runs."""
    batch, jbatch, jm, variables = jax_setup()
    rng = jax.random.key(SEED)
    cfg = dict(CFG)

    def forward_loss(params):
        preds = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                         jbatch["images"], True)
        losses = JM.compute_loss(preds, jbatch, model_cfg=cfg, rng=rng)
        pts = jax.random.uniform(rng, (cfg["num_points"], 2))
        gt_pts = jax.vmap(lambda m: JM._sample_points(m, pts))(jbatch["gt_masks"])
        assigns = []
        for li in range(preds["cls_logits"].shape[0]):
            pred_pts = jax.vmap(lambda m: JM._sample_points(m, pts))(preds["mask_logits"][li])
            cost = jax.vmap(lambda pb, pp, tc, tp, tm: JM.matcher_cost(
                pb, pp, tc, tp, tm, w_ce=2.0, w_bce=5.0, w_dice=5.0,
                num_points=cfg["num_points"]))(
                jax.nn.softmax(preds["cls_logits"][li], -1), pred_pts,
                jbatch["gt_classes_seg"], gt_pts, jbatch["gt_mask_valid"])
            assigns.append(j_hungarian(cost, jbatch["gt_mask_valid"]))
        return losses, preds, jnp.stack(assigns)

    step = lower_smooth(forward_loss, variables["params"])
    draws = jax_draws(rng, 2, 4, CFG["num_points"])
    out = {}
    for smooth in (False, True):
        losses, preds, assign = step(variables["params"], jnp.asarray(smooth))
        run = dict(preds=jax.tree_util.tree_map(np.asarray, preds),
                   losses={k: float(v) for k, v in losses.items()}, assign=np.asarray(assign))
        out[smooth] = dict(jax=run, port=_port_run(variables, batch, draws, smooth))
    return out


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


@pytest.mark.parametrize("key", ["cls_logits", "mask_logits"])
def test_forward_matches(m2f, key):
    got, want = m2f[False]["port"]["preds"][key], m2f[False]["jax"]["preds"][key]
    assert got.shape == want.shape
    for li in range(want.shape[0]):
        assert _rel(got[li], want[li]) <= OUT_TOL, li


def test_attention_mask_bits_match(m2f):
    """Decoder layer i attends by the mask logits of prediction i resized
    to its scale (res5, res4, res3 in turn: 2², 4², 8² at 64×64)."""
    jm = m2f[False]["jax"]["preds"]["mask_logits"]
    tm = m2f[False]["port"]["preds"]["mask_logits"]
    b, q = jm.shape[1:3]
    near = 0
    for i in range(MODEL["dec_layers"]):
        s = 2 * 2 ** (i % 3)
        pre = np.asarray(jax.nn.sigmoid(jax.image.resize(jnp.asarray(jm[i]), (b, q, s, s),
                                                         "bilinear")))
        got = (torch.sigmoid(resize(tm[i], (b, q, s, s), "bilinear")) > 0.5).numpy()
        clear = np.abs(pre - 0.5) > BAND
        near += int((~clear).sum())
        np.testing.assert_array_equal(got[clear], (pre > 0.5)[clear], err_msg=f"layer {i}")
        assert (pre > 0.5).any() and (pre <= 0.5).any()
    assert near == 0


@pytest.mark.parametrize("smooth", [False, True], ids=["relu", "gelu"])
def test_assignments_match(m2f, smooth):
    run = m2f[smooth]
    np.testing.assert_array_equal(run["port"]["assign"].numpy(), run["jax"]["assign"])
    assert (run["jax"]["assign"] >= 0).sum() == 4 * 5  # 5 valid GT over the batch, every layer


@pytest.mark.parametrize("smooth", [False, True], ids=["relu", "gelu"])
def test_losses_match(m2f, smooth):
    want, got = m2f[smooth]["jax"]["losses"], m2f[smooth]["port"]["losses"]
    assert set(got) == set(want) and len(want) == 13
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_TOL * max(abs(w), 1.0), (k, got[k], w)


def test_swin_trunk_builds_and_runs():
    swin = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=7)
    tm = TM.Mask2Former(num_classes=4, num_queries=8, d_model=32, dec_layers=3,
                        backbone="swin", swin_cfg=swin, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tm.eval()
    with torch.no_grad():
        out = tm(torch.zeros(1, 64, 96, 3))
    assert out["cls_logits"].shape == (4, 1, 8, 5)
    assert out["mask_logits"].shape == (4, 1, 8, 16, 24)
    assert torch.isfinite(out["mask_logits"]).all()
