"""Port parity: TrajectoryFormer (efg_tpu_torch vs efg_tpu) on the same
numpy inputs and the same weights (efg_tpu's flax init, mapped by
`flax_to_state_dict`), at tiny widths: d_model 32, 1-2 layers, 16 points,
history 3, 8 hypotheses, 512 points.

The device box ops and the point crop (masks and the crop's points bit
for bit); the core's forward, `compute_loss` and the step-1 gradients of
every leaf on several seeds, an invalid hypothesis (an all-False row of
`group_mask`) among them; the batched detection form with its loss and
`det_predict`; the motion pretrain's model, loss and gradients; the
strict weight mapping of both flax trees; the graft of a pretrain
checkpoint. efg_tpu's model runs under `jax.jit`."""

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.geometry import box_ops_jnp as JG
from efg_tpu.models import trajectoryformer as JTF
from efg_tpu_torch.geometry import box_ops_torch as TG
from efg_tpu_torch.models import trajectoryformer as TTF
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

D_MODEL, LAYERS, POINTS, HISTORY, N_HYP, N_PTS = 32, 2, 16, 3, 8, 512
FWD_TOL = 1e-5  # forward outputs and losses, absolute at O(1) values
GRAD_TOL = 1e-4  # each leaf's step-1 gradient, relative to the leaf's max
SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rs, n, extent=4.0):
    return np.column_stack([rs.uniform(-extent, extent, (n, 2)), rs.uniform(-0.5, 0.5, (n, 1)),
                            rs.uniform(1.0, 4.0, (n, 3)),
                            rs.uniform(-np.pi, np.pi, (n, 1))]).astype(np.float32)


def _scene(seed, n=N_HYP, n_pts=N_PTS):
    """Points clustered in and around `n` boxes (some boxes hold more than
    POINTS points, one holds none), a masked tail, and GT boxes near the
    hypotheses (some above IoU 0.7, some below 0.3)."""
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, n)
    boxes[-1, :2] = (14.0, -14.0)  # away from every point
    pts = []
    for i, b in enumerate(boxes[:-1]):  # the last box gets no points of its own
        k = rs.randint(4, 3 * POINTS)
        local = rs.uniform(-0.6, 0.6, (k, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        pts.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                             local[:, 0] * s + local[:, 1] * c + b[1], local[:, 2] + b[2]], 1))
    xyz = np.concatenate(pts)[:n_pts]
    xyz = np.concatenate([xyz, rs.uniform(-8, 8, (n_pts - len(xyz), 3))])
    points = np.concatenate([xyz, rs.uniform(0, 1, (n_pts, 1))], 1).astype(np.float32)
    points[-40:, :2] += 20.0  # far away: never inside a box
    mask = np.ones(n_pts, bool)
    mask[-60:] = False
    gt = boxes[: n - 2].copy()
    gt[:, :2] += rs.randn(n - 2, 2).astype(np.float32) * np.float32(0.15)
    gt[1:3, :2] += 3.0  # far from their hypotheses
    gt[:, 6] += rs.randn(n - 2).astype(np.float32) * np.float32(0.05)
    gt_mask = np.ones(n - 2, bool)
    gt_mask[-1] = False
    return dict(points=points, mask=mask, boxes=boxes, gt=gt.astype(np.float32), gt_mask=gt_mask)


def _core_inputs(seed, invalid=(N_HYP - 1,)):
    """One frame's hypotheses: the crop of `_scene`, random trajectories
    with some steps masked, groups of two, and invalid slots."""
    sc = _scene(seed)
    rs = np.random.RandomState(seed + 100)
    hp, hm = _jcrop(jnp.asarray(sc["points"]), jnp.asarray(sc["mask"]),
                    jnp.asarray(sc["boxes"]), num_points=POINTS)
    valid = np.ones(N_HYP, bool)
    valid[list(invalid)] = False
    traj_mask = rs.uniform(size=(N_HYP, HISTORY)) > 0.3
    traj_mask[0] = False  # a hypothesis without history
    return sc, dict(hyp_points=np.asarray(hp), hyp_pts_mask=np.asarray(hm),
                    hyp_traj=rs.randn(N_HYP, HISTORY, 8).astype(np.float32),
                    hyp_traj_mask=traj_mask, hyp_boxes=sc["boxes"],
                    group_ids=np.repeat(np.arange(N_HYP // 2), 2).astype(np.int32), valid=valid)


def _jax_variables(module, args, seed=0, **kw):
    return jax.device_get(jax.jit(lambda a: module.init(jax.random.key(seed), **a, **kw))(args))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# An attention key projection's bias adds the same q·b to every logit of a
# query's row, which the softmax takes away: its true gradient is zero, and
# both packages leave rounding noise there (up to 1e-8 here).
ZERO_GRAD = re.compile(r"attn\.key\.bias$")
ZERO_GRAD_ABS = 1e-6


def _leaf_errs(got: dict, want: dict):
    """Per leaf: max |got - want| over the leaf's max |want|; the leaves
    whose true gradient is zero (ZERO_GRAD) read 0 while both sides stay
    below ZERO_GRAD_ABS."""
    assert set(got) == set(want)
    errs = {}
    for k in want:
        if ZERO_GRAD.search(k):
            peak = max(float(got[k].abs().max()), float(want[k].abs().max()))
            errs[k] = 0.0 if peak < ZERO_GRAD_ABS else float("inf")
        else:
            errs[k] = float((got[k] - want[k]).abs().max() / max(float(want[k].abs().max()), 1e-12))
    return errs


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_box_ops_match(margin):
    rs = np.random.RandomState(3)
    boxes = _boxes(rs, 12)
    boxes[0, 6] = 0.0
    pts = rs.uniform(-6, 6, (400, 3)).astype(np.float32)
    pts[:12] = boxes[:, :3]  # centres
    corners = np.asarray(JG.boxes_to_corners_3d(jnp.asarray(boxes)))
    pts[12:20] = corners[1]  # on a box's faces
    np.testing.assert_array_equal(
        TG.points_in_rbbox(_t(pts), _t(boxes), margin=margin).numpy(),
        np.asarray(JG.points_in_rbbox(jnp.asarray(pts), jnp.asarray(boxes), margin=margin)))
    np.testing.assert_allclose(TG.boxes_to_corners_3d(_t(boxes)).numpy(), corners, atol=1e-6)
    angle = rs.uniform(-3, 3, 12).astype(np.float32)
    pts3 = rs.randn(12, 5, 4).astype(np.float32)
    np.testing.assert_allclose(
        TG.rotate_points_along_z(_t(pts3), _t(angle)).numpy(),
        np.asarray(JG.rotate_points_along_z(jnp.asarray(pts3), jnp.asarray(angle))), atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_crop_matches(seed):
    """Masks bit for bit (which points a box takes, in index order, the
    first POINTS of them), the crop's features within rounding."""
    sc = _scene(seed)
    jf, jm = _jcrop(jnp.asarray(sc["points"]), jnp.asarray(sc["mask"]),
                    jnp.asarray(sc["boxes"]), num_points=POINTS)
    tf, tm = TTF.crop_hypothesis_points(_t(sc["points"])[None], _t(sc["mask"])[None],
                                        _t(sc["boxes"])[None], num_points=POINTS)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_allclose(tf[0].numpy(), np.asarray(jf), atol=1e-6)
    counts = np.asarray(jm).sum(1)
    assert counts.max() == POINTS and counts.min() == 0  # truncated boxes and an empty one
    # the port takes the first inside points by index
    inside = (np.asarray(JG.points_in_rbbox(jnp.asarray(sc["points"]), jnp.asarray(sc["boxes"]),
                                            margin=0.5)) & sc["mask"][:, None])
    for b in range(N_HYP):
        first = np.nonzero(inside[:, b])[0][:POINTS]
        local = sc["points"][first, 2] - sc["boxes"][b, 2]
        np.testing.assert_allclose(tf[0, b, : len(first), 2].numpy(), local, atol=1e-6)


# ---------------------------------------------------------------- the core

JCORE = JTF.TrajectoryFormer(d_model=D_MODEL, num_layers=LAYERS, num_points=POINTS,
                             history=HISTORY)
# one compile of each efg_tpu function for every seed
_jcrop = jax.jit(JTF.crop_hypothesis_points, static_argnames="num_points")
_jcore_init = jax.jit(lambda key, a: JCORE.init(key, **a, train=True))


@jax.jit
def _jcore_step(params, args, gt, gt_mask):
    def loss_fn(p):
        out = JCORE.apply({"params": p}, **args, train=True)
        losses = JTF.compute_loss(out, args["hyp_boxes"], gt, gt_mask, args["valid"])
        return losses["loss"], (out, losses)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


@functools.lru_cache(maxsize=None)
def _core_case(seed, weight_seed=0):
    sc, args = _core_inputs(seed)
    variables = jax.device_get(_jcore_init(jax.random.key(weight_seed),
                                           {k: jnp.asarray(v) for k, v in args.items()}))
    return sc, args, variables


def _core_pair(seed, weight_seed=0):
    sc, args, variables = _core_case(seed, weight_seed)
    tm = TTF.TrajectoryFormer(D_MODEL, LAYERS, POINTS, HISTORY)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return sc, args, JCORE, variables, tm


def _jax_core_step(jm, variables, args, sc):
    return _jcore_step(variables["params"], args, jnp.asarray(sc["gt"]), jnp.asarray(sc["gt_mask"]))


def _torch_core_step(tm, args, sc):
    tm.zero_grad()
    out = tm(*(_t(args[k])[None] for k in ("hyp_points", "hyp_pts_mask", "hyp_traj",
                                           "hyp_traj_mask", "hyp_boxes", "group_ids", "valid")))
    out = {k: v[0] for k, v in out.items()}
    losses = TTF.compute_loss(out, _t(args["hyp_boxes"]), _t(sc["gt"]), _t(sc["gt_mask"]),
                              _t(args["valid"]))
    losses["loss"].backward()
    return out, losses, {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("seed", SEEDS)
def test_core_forward_loss_and_grads_match(seed):
    """Forward outputs and loss parts within FWD_TOL, every leaf's step-1
    gradient within GRAD_TOL of its max. The last hypothesis is invalid:
    its `group_mask` row is all False, which flax's finite mask value
    turns into uniform local attention (NaN with −inf); its features and
    scores match and stay finite."""
    sc, args, jm, variables, tm = _core_pair(seed, weight_seed=seed)
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    (_, (jout, jlosses)), jgrads = _jax_core_step(jm, variables, jargs, sc)
    tout, tlosses, tgrads = _torch_core_step(tm, args, sc)
    for k in ("scores", "refine", "features"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=FWD_TOL,
                                   err_msg=k)
    assert torch.isfinite(tout["features"][~_t(args["valid"])]).all()
    for k in ("loss_cls", "loss_reg", "loss", "num_pos"):
        assert float(tlosses[k].detach()) == pytest.approx(float(jlosses[k]), abs=FWD_TOL), k
    assert float(tlosses["num_pos"]) >= 1  # the regression branch runs
    want = {k: v for k, v in flax_to_state_dict(tm, {"params": jgrads}).items()}
    errs = _leaf_errs(tgrads, want)
    assert max(errs.values()) < GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert all(torch.isfinite(g).all() for g in tgrads.values())


def test_invalid_row_would_be_nan_with_negative_infinity():
    """The witness for the mask value: the same layer with −inf as the
    masked logit reads NaN on the invalid hypothesis, the port's finite
    value reads efg_tpu's uniform attention."""
    from efg_tpu_torch.models import voxel_detr as VD

    _, args, _, _, tm = _core_pair(0)
    layer = tm.layer0
    x = torch.randn(1, N_HYP, D_MODEL, generator=torch.Generator().manual_seed(0))
    valid = _t(args["valid"])[None]
    g = _t(args["group_ids"])[None]
    gm = (g[:, :, None] == g[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    assert not gm[0, -1].any()
    assert torch.isfinite(layer(x, gm)).all()
    orig = torch.finfo
    try:
        VD.torch.finfo = lambda dtype: type("F", (), {"min": float("-inf")})
        assert torch.isnan(layer(x, gm)[0, -1]).all()
    finally:
        VD.torch.finfo = orig


# ------------------------------------------------------ the detection form

def _det_batch(seeds=(4, 5)):
    scs = [_scene(s) for s in seeds]
    b = len(scs)
    det = np.zeros((b, N_HYP, 9), np.float32)
    gt = np.zeros((b, N_HYP, 9), np.float32)
    gt_mask = np.zeros((b, N_HYP), bool)
    det_mask = np.ones((b, N_HYP), bool)
    det_mask[1, -2:] = False
    classes = np.zeros((b, N_HYP), np.int32)
    for i, sc in enumerate(scs):
        det[i, :, :6], det[i, :, 8] = sc["boxes"][:, :6], sc["boxes"][:, 6]
        det[i, :, 6:8] = np.random.RandomState(i).randn(N_HYP, 2)
        g = len(sc["gt"])
        gt[i, :g, :6], gt[i, :g, 8] = sc["gt"][:, :6], sc["gt"][:, 6]
        gt_mask[i, :g] = sc["gt_mask"]
        classes[i, :g] = np.arange(g) % 3 + 1
    return dict(points=np.stack([s["points"] for s in scs]),
                points_mask=np.stack([s["mask"] for s in scs]), det_boxes=det, det_mask=det_mask,
                gt_boxes=gt, gt_mask=gt_mask, gt_classes=classes,
                det_labels=np.where(det_mask, classes, 0).astype(np.int32))


def test_det_form_loss_and_predict_match():
    """`TrajectoryFormerDet` (efg_tpu vmaps the frames, the port batches
    them), `det_compute_loss` and `det_predict`, whose labels come from
    `det_labels` in the port: equal to efg_tpu's GT-slot labels here,
    where detection i stands for GT i."""
    batch = _det_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JTF.TrajectoryFormerDet(d_model=D_MODEL, num_layers=1, num_points=POINTS,
                                 history=HISTORY)
    akw = dict(points=jb["points"], points_mask=jb["points_mask"], det_boxes=jb["det_boxes"],
               det_mask=jb["det_mask"])
    variables = _jax_variables(jm, akw, 7, train=True)

    def run(params):
        out = jm.apply({"params": params}, **akw, train=True)
        losses = JTF.det_compute_loss(out, jb)
        return losses["loss"], (out, losses, JTF.det_predict(out, jb))

    (_, (jout, jlosses, jpred)), jgrads = jax.jit(jax.value_and_grad(run, has_aux=True))(
        variables["params"])
    tm = TTF.TrajectoryFormerDet(D_MODEL, 1, POINTS, HISTORY, device="cpu")
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    tb = {k: _t(v) for k, v in batch.items()}
    tout = tm(tb["points"], tb["points_mask"], tb["det_boxes"], tb["det_mask"])
    tlosses = TTF.det_compute_loss(tout, tb)
    tlosses["loss"].backward()
    tpred = TTF.det_predict({k: v.detach() for k, v in tout.items()}, tb)
    for k in ("scores", "refine"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=FWD_TOL)
    for k in jlosses:
        assert float(tlosses[k].detach()) == pytest.approx(float(jlosses[k]), abs=FWD_TOL), k
    for k in ("box3d", "scores"):
        np.testing.assert_allclose(tpred[k].numpy(), np.asarray(jpred[k]), atol=FWD_TOL)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(tpred[k].numpy(), np.asarray(jpred[k]))
    want = flax_to_state_dict(tm, {"params": jgrads})
    errs = _leaf_errs({n: p.grad for n, p in tm.named_parameters()}, want)
    assert max(errs.values()) < GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


def test_refinement_starts_as_identity():
    """The zero-initialised regression head leaves the boxes as they are
    (`apply_refinement` of a zero refinement)."""
    rs = np.random.RandomState(9)
    boxes = _boxes(rs, 6)
    got = TTF.apply_refinement(_t(boxes), torch.zeros(6, 7)).numpy()
    np.testing.assert_allclose(got, boxes, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(JTF.apply_refinement(jnp.asarray(boxes), jnp.zeros((6, 7)))), atol=1e-6)


# ------------------------------------------------- the pretrain and graft

def _motion_batch(seed=6, b=2, n=5, f=4):
    rs = np.random.RandomState(seed)
    mask = rs.uniform(size=(b, n, HISTORY)) > 0.3
    mask[0, 0] = False
    fmask = rs.uniform(size=(b, n, f)) > 0.2
    return dict(traj_hist=rs.randn(b, n, HISTORY, 8).astype(np.float32), traj_mask=mask,
                future_offsets=rs.randn(b, n, f, 3).astype(np.float32), future_mask=fmask)


@pytest.mark.parametrize("seed", SEEDS)
def test_motion_prediction_matches(seed):
    """The pretrain model (its future head zero-initialised in both, so
    the test also perturbs it), its loss and gradients."""
    batch = _motion_batch(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JTF.MotionPrediction(d_model=D_MODEL, num_future=4)
    variables = _jax_variables(jm, {"traj": jb["traj_hist"], "traj_mask": jb["traj_mask"]},
                               seed, train=True)
    head = variables["params"]["future_head"]
    head["kernel"] = np.random.RandomState(seed).randn(*head["kernel"].shape).astype(np.float32)

    def run(params):
        out = jm.apply({"params": params}, jb["traj_hist"], jb["traj_mask"], train=True)
        return JTF.motion_compute_loss(out, jb)["loss"], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(run, has_aux=True))(variables["params"])
    tm = TTF.MotionPrediction(D_MODEL, 4, device="cpu")
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    tb = {k: _t(v) for k, v in batch.items()}
    tout = tm(tb["traj_hist"], tb["traj_mask"])
    tloss = TTF.motion_compute_loss(tout, tb)
    tloss["loss"].backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=FWD_TOL)
    assert float(tloss["loss"]) == pytest.approx(float(jloss), abs=FWD_TOL)
    want = flax_to_state_dict(tm, {"params": jgrads})
    errs = _leaf_errs({n: p.grad for n, p in tm.named_parameters()}, want)
    assert max(errs.values()) < GRAD_TOL, errs
    pred = TTF.motion_predict(tout, tb)
    jpred = JTF.motion_predict(jout, jb)
    assert {k: tuple(v.shape) for k, v in pred.items()} == {k: v.shape for k, v in jpred.items()}
    assert not pred["valid"].any()


def test_weight_mapping_is_strict():
    """Both flax trees map leaf for leaf; a leaf missing or left over, or
    a wrong shape, raises."""
    _, args, _, variables, tm = _core_pair(0)
    sd = flax_to_state_dict(tm, variables)
    assert set(sd) == set(tm.state_dict())
    assert any(k.startswith("layer1.local_attn.query") for k in sd)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["spare"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(tm, extra)
    missing = jax.tree.map(lambda x: x, variables)
    del missing["params"]["box_embed"]["bias"]
    with pytest.raises(KeyError, match="box_embed"):
        flax_to_state_dict(tm, missing)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(TTF.TrajectoryFormer(D_MODEL * 2, LAYERS, POINTS, HISTORY), variables)


def test_graft_copies_the_pretrain_encoder(tmp_path):
    """`load_motion_encoder` copies every `motion_encoder.*` tensor of a
    port checkpoint into `core.motion_encoder.*`, bit for bit, and nothing
    else; a checkpoint of another width is refused. `resolve_motion_model`
    reads efg_run's `log` link as the port's `log_torch`."""
    pre = TTF.MotionPrediction(128, 5, device="cpu", generator=torch.Generator().manual_seed(1))
    path = tmp_path / "model_final"
    torch.save({"model": pre.state_dict()}, path)
    det = TTF.TrajectoryFormerDet(D_MODEL, 1, POINTS, HISTORY, device="cpu")
    before = {k: v.clone() for k, v in det.state_dict().items()}
    grafted = TTF.load_motion_encoder(det, str(path))
    after = det.state_dict()
    assert sorted(grafted) == sorted(k for k in after if k.startswith("core.motion_encoder."))
    for k, v in after.items():
        if k in grafted:
            assert torch.equal(v, pre.state_dict()[k[len("core."):]]), k
        else:
            assert torch.equal(v, before[k]), k
    narrow = TTF.MotionPrediction(64, 5, device="cpu")
    torch.save({"model": narrow.state_dict()}, tmp_path / "narrow")
    with pytest.raises(ValueError, match="shape"):
        TTF.load_motion_encoder(det, str(tmp_path / "narrow"))
    assert TTF.resolve_motion_model("../pre/log/model_final").endswith(
        "/pre/log_torch/model_final")
