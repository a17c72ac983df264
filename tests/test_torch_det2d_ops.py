"""Port parity of the 2D detectors' host-free pieces (efg_tpu_torch vs
efg_tpu) on the same numpy inputs, no model:

- `iou_xyxy` and `batched_nms`, bit for bit (keep indices and flags), on
  exact score ties, duplicate boxes and several classes, with padding past
  `pre_max`;
- anchors (`generate_cell_anchors`, `grid_anchors`) bit for bit, and
  `Box2BoxTransform` both ways with `scale_clamp` reached, at a few ulp;
- `fcos_targets` and `retinanet_targets` bit for bit: classes, match slots,
  the ignore band, forced low-quality matches, equal-area ties, crowd-free
  padding slots;
- the three models' losses at 1e-5 on the same predictions, and their
  `predict` keep sets equal;
- `WarmupMultiStep` with its three warm-up methods, at 1e-7.

Shapes are those of a 64×64 image (p3-p7: 8², 4², 2², 1², 1²)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.modeling.assigners import anchor_generator as JA
from efg_tpu.models import autoassign as JAA
from efg_tpu.models import fcos as JF
from efg_tpu.models import retinanet as JR
from efg_tpu.ops import nms2d as JN
from efg_tpu.solver import schedulers as JSCHED
from efg_tpu_torch.modeling.assigners import anchor_generator as TA
from efg_tpu_torch.models import autoassign as TAA
from efg_tpu_torch.models import fcos as TF
from efg_tpu_torch.models import retinanet as TR
from efg_tpu_torch.ops import nms2d as TN
from efg_tpu_torch.solver import schedulers as TSCHED

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
STRIDES = [8, 16, 32, 64, 128]
R = sum(h * w for h, w in SHAPES)  # 86 positions
C = 5
CFG = dict(num_classes=C, fpn_strides=STRIDES, center_sampling_radius=1.5)
LOSS_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def gt_2d(seed, bsz=2, g=8, size=64.0):
    """GT boxes [B, G, 4] in a size×size image with the cases the
    assignment must get right: two boxes of equal area at one place (the
    first slot wins), a box nested in another, padding slots, and one image
    with a single box."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((bsz, g, 4), np.float32)
    cls = np.zeros((bsz, g), np.int32)
    mask = np.zeros((bsz, g), bool)
    for b in range(bsz):
        k = 5 if b == 0 else 1
        x0 = rs.uniform(0, size * 0.6, k)
        y0 = rs.uniform(0, size * 0.6, k)
        w = rs.uniform(8, size * 0.5, k)
        h = rs.uniform(8, size * 0.5, k)
        boxes[b, :k] = np.stack([x0, y0, x0 + w, y0 + h], -1)
        cls[b, :k] = rs.randint(0, C, k)
        mask[b, :k] = True
    # box 0 transposed: the same area at the same place, so slot 0 wins
    boxes[0, 5] = [boxes[0, 0, 0], boxes[0, 0, 1], boxes[0, 0, 0] + (boxes[0, 0, 3] - boxes[0, 0, 1]),
                   boxes[0, 0, 1] + (boxes[0, 0, 2] - boxes[0, 0, 0])]
    cls[0, 5], mask[0, 5] = (cls[0, 0] + 1) % C, True
    boxes[0, 6] = [20, 20, 30, 30]  # nested in a larger box below
    boxes[0, 7] = [10, 10, 50, 50]
    cls[0, 6:8], mask[0, 6:8] = [1, 2], True
    return boxes, cls, mask


def preds_2d(seed, bsz=2, retina=False):
    rs = np.random.RandomState(seed)
    a = 9 if retina else 1
    out = dict(logits=rs.randn(bsz, R * a, C).astype(np.float32) * 2 - 2,
               deltas=(rs.randn(bsz, R * a, 4) * (0.3 if retina else 1.0)).astype(np.float32))
    if not retina:
        out["deltas"] = np.abs(out["deltas"]) * 12 + 1  # ltrb ≥ 0, as the head's ReLU·stride
        out["centerness"] = rs.randn(bsz, R, 1).astype(np.float32)
    return out


def _both(pred_np, extra=None):
    """efg_tpu's predictions (without `shapes`: `_jit` adds them) and the
    port's."""
    j = {k: jnp.asarray(v) for k, v in pred_np.items()}
    t = {k: _t(v) for k, v in pred_np.items()}
    t["shapes"] = SHAPES
    for k, v in (extra or {}).items():
        j[k], t[k] = jnp.asarray(v), _t(v)
    return j, t


_JITTED = {}


def _jit(fn, **kw):
    """efg_tpu's `fn(preds, ...)` jitted once (eagerly, every jnp op
    compiles on its own first call), with the static `shapes` and
    keyword arguments closed over."""
    key = (fn, repr(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda preds, *a: fn({**preds, "shapes": SHAPES}, *a, **kw))
    return _JITTED[key]


def _batch(seed):
    boxes, cls, mask = gt_2d(seed)
    j = dict(gt_boxes2d=jnp.asarray(boxes), gt_classes2d=jnp.asarray(cls), gt_mask2d=jnp.asarray(mask))
    t = dict(gt_boxes2d=_t(boxes), gt_classes2d=_t(cls), gt_mask2d=_t(mask))
    return j, t


# ------------------------------------------------------------------ NMS

def _nms_case(seed, n=300):
    """Boxes in clusters (heavy overlap), scores with exact ties, 4 labels,
    invalid rows; rows 0-9 duplicate rows 10-19 with equal scores."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(20, 180, (2, 12, 2))
    pick = rs.randint(0, 12, (2, n))
    c = np.take_along_axis(centres, pick[..., None].repeat(2, -1), 1) + rs.randn(2, n, 2) * 4
    wh = rs.uniform(10, 40, (2, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.round(rs.uniform(0, 1, (2, n)), 2).astype(np.float32)  # many exact ties
    boxes[:, :10], scores[:, :10] = boxes[:, 10:20], scores[:, 10:20]
    scores[:, rs.rand(n) < 0.1] = -1e9  # invalid
    labels = rs.randint(0, 4, (2, n)).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("pre_max,post_max,thr", [(1000, 100, 0.6), (64, 100, 0.5), (200, 50, 0.3)])
def test_batched_nms_bit_for_bit(pre_max, post_max, thr):
    boxes, scores, labels = _nms_case(pre_max)
    j_idx, j_valid = jax.vmap(lambda b, s, l: JN.batched_nms(
        b, s, l, iou_threshold=thr, pre_max=pre_max, post_max=post_max))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels))
    t_idx, t_valid = TN.batched_nms(_t(boxes), _t(scores), _t(labels), iou_threshold=thr,
                                    pre_max=pre_max, post_max=post_max)
    _eq(t_valid, j_valid, "valid")
    _eq(t_idx.numpy()[t_valid.numpy()], np.asarray(j_idx)[np.asarray(j_valid)], "kept indices")
    assert t_idx.shape == (2, post_max) and int(t_valid.sum()) > 0


def test_iou_xyxy_bit_for_bit():
    boxes, _, _ = _nms_case(1, n=40)
    a, b = boxes[0], boxes[1, :17]
    j_iou = jax.jit(JN.iou_xyxy)
    _eq(TN.iou_xyxy(_t(a), _t(b)), j_iou(jnp.asarray(a), jnp.asarray(b)), "iou")
    degenerate = np.array([[5, 5, 5, 9], [0, 0, 4, 4]], np.float32)  # zero width; a corner touch
    _eq(TN.iou_xyxy(_t(degenerate), _t(degenerate)),
        j_iou(jnp.asarray(degenerate), jnp.asarray(degenerate)), "degenerate")


# -------------------------------------------------------------- anchors

def test_anchors_and_box_codec_bit_for_bit():
    _eq(TA.generate_cell_anchors((32, 40, 50), (0.5, 1.0, 2.0)),
        JA.generate_cell_anchors((32, 40, 50), (0.5, 1.0, 2.0)), "cell")
    for t, j in zip(TA.grid_anchors(SHAPES, STRIDES, TR.ANCHOR_SIZES, TR.ASPECT_RATIOS),
                    JA.grid_anchors(SHAPES, STRIDES, JR.ANCHOR_SIZES, JR.ASPECT_RATIOS)):
        _eq(t, j, "grid")
    anchors = TR.anchors_for(SHAPES, STRIDES, "cpu").numpy()
    _eq(anchors, JR._anchors_for(SHAPES, STRIDES), "all levels")
    rs = np.random.RandomState(3)
    tgt = anchors + rs.uniform(-20, 20, anchors.shape).astype(np.float32)
    deltas = rs.randn(*anchors.shape).astype(np.float32) * 3
    deltas[:5, 2:] = 9.0  # past scale_clamp = log(1000 / 16)
    weights = (10.0, 10.0, 5.0, 5.0)
    # the codec's log and exp are libm's in torch and XLA's own in efg_tpu:
    # they differ in the last bit, so it is held at a few ulp
    for w in ((1.0, 1.0, 1.0, 1.0), weights):
        tc, jc = TA.Box2BoxTransform(w), JA.Box2BoxTransform(w)
        np.testing.assert_allclose(
            tc.get_deltas(_t(anchors), _t(tgt)).numpy(),
            np.asarray(jax.jit(jc.get_deltas)(jnp.asarray(anchors), jnp.asarray(tgt))), rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(
            tc.apply_deltas(_t(deltas), _t(anchors)).numpy(),
            np.asarray(jax.jit(jc.apply_deltas)(jnp.asarray(deltas), jnp.asarray(anchors))), rtol=1e-6,
            atol=1e-3)  # boxes up to 1e5 px after the clamp


# -------------------------------------------------------------- targets

@pytest.mark.parametrize("radius", [1.5, 0.0])
def test_fcos_targets_bit_for_bit(radius):
    boxes, cls, mask = gt_2d(4)
    shifts_j = jnp.concatenate(JF.level_shifts(SHAPES, STRIDES), 0)
    lvl = np.concatenate([np.full(h * w, i) for i, (h, w) in enumerate(SHAPES)])
    strides = np.asarray(STRIDES, np.float32)
    soi = np.asarray(JF.SIZES_OF_INTEREST, np.float32)
    want = jax.jit(jax.vmap(lambda b, c, m: JF.fcos_targets(
        shifts_j, jnp.asarray(lvl, jnp.int32), jnp.asarray(strides), jnp.asarray(soi), b, c, m,
        num_classes=C, center_sampling_radius=radius)))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(mask))
    shifts_t, lvl_t = TF.all_shifts(SHAPES, STRIDES, "cpu")
    _eq(shifts_t, shifts_j, "shifts")
    got = TF.fcos_targets(shifts_t, lvl_t, _t(strides), _t(soi), _t(boxes), _t(cls).long(),
                          _t(mask), num_classes=C, center_sampling_radius=radius)
    for g, w, what in zip(got, want, ("classes", "deltas", "centerness")):
        _eq(g, w, what)
    fg = np.asarray(want[0]) < C
    assert 3 < fg.sum() < fg.size  # foreground and background both present


def test_retinanet_targets_bit_for_bit():
    boxes, cls, mask = gt_2d(5)
    anchors = TR.anchors_for(SHAPES, STRIDES, "cpu")
    want = jax.jit(jax.vmap(lambda b, c, m: JR.retinanet_targets(
        jnp.asarray(anchors.numpy()), b, c, m, num_classes=C)))(
        jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(mask))
    got = TR.retinanet_targets(anchors, _t(boxes), _t(cls).long(), _t(mask), num_classes=C)
    _eq(got[0], want[0], "classes")
    _eq(got[1], want[1], "match")
    c = np.asarray(want[0])
    assert (c == -1).any() and (c == C).any() and ((c >= 0) & (c < C)).any()


# ---------------------------------------------------------------- losses

def _losses_close(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= LOSS_TOL * max(abs(w), 1.0), (k, float(got[k]), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_fcos_loss_matches(seed):
    jp, tp = _both(preds_2d(seed))
    jb, tb = _batch(seed + 10)
    _losses_close(TF.compute_loss(tp, tb, model_cfg=CFG), _jit(JF.compute_loss, model_cfg=CFG)(jp, jb))


@pytest.mark.parametrize("seed", [0, 1])
def test_retinanet_loss_matches(seed):
    jp, tp = _both(preds_2d(seed, retina=True))
    jb, tb = _batch(seed + 20)
    _losses_close(TR.compute_loss(tp, tb, model_cfg=CFG), _jit(JR.compute_loss, model_cfg=CFG)(jp, jb))


@pytest.mark.parametrize("seed", [0, 1])
def test_autoassign_loss_matches(seed):
    rs = np.random.RandomState(seed + 40)
    prior = dict(mu=rs.uniform(-0.5, 0.5, (C, 2)).astype(np.float32),
                 sigma=rs.uniform(0.6, 1.4, (C, 2)).astype(np.float32))
    jp, tp = _both(preds_2d(seed), prior)
    jb, tb = _batch(seed + 30)
    _losses_close(TAA.compute_loss(tp, tb, model_cfg=CFG),
                  _jit(JAA.compute_loss, model_cfg=CFG)(jp, jb))


@pytest.mark.parametrize("model", ["fcos", "retinanet"])
def test_predict_keep_sets_equal(model):
    retina = model == "retinanet"
    pred = preds_2d(7, retina=retina)
    pred["logits"] = pred["logits"] + 3.0  # most positions above the score threshold
    jp, tp = _both(pred)
    jm, tm = (JR, TR) if retina else (JF, TF)
    kw = dict(score_threshold=0.05, nms_threshold=0.5, pre_max=200, post_max=50)
    want = _jit(jm.predict, model_cfg=CFG, **kw)(jp)
    got = tm.predict(tp, model_cfg=CFG, **kw)
    _eq(got["valid"], want["valid"], "valid")
    _eq(got["labels"], want["labels"], "labels")
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-6,
                               atol=1e-4)
    assert int(got["valid"].sum()) > 10


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("method", ["linear", "constant", "burnin"])
def test_warmup_multistep_matches(method):
    kw = dict(lr=0.01, milestones=[6, 9], gamma=0.1, warmup_iters=5, warmup_factor=0.001,
              warmup_method=method)
    j_lr, j_mom = JSCHED.build_scheduler(dict(type="WarmupMultiStep", **kw))
    t_lr, t_mom = TSCHED.build_scheduler(dict(type="WarmupMultiStep", **kw))
    assert j_mom is None and t_mom is None
    for step in range(12):
        np.testing.assert_allclose(float(t_lr(step)), float(j_lr(step)), rtol=1e-7, atol=0)
    with pytest.raises(ValueError, match="Unknown warmup method"):
        TSCHED.warmup_factor_at("cosine", 0, 5, 0.1)
