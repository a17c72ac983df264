"""Port parity of Mask2Former's ops and heads (efg_tpu_torch vs efg_tpu),
on numpy inputs made from a seed:

- `ops/resize.py` against `jax.image.resize`: antialiased bilinear 8×,
  4× and 2× down (the masked attention's shrink), half-pixel nearest 2×
  up (the pixel decoder), Keys cubic (Swin's APE) down and up, and an
  odd-sized bilinear: within 1e-6 of each output's max;
- `ms_deform_attn_sample`, with sampling locations outside the maps:
  1e-5;
- the criterion's pieces: `_sample_points` (one point set and a set per
  pair), `uncertainty_point_coords` with efg_tpu's candidates (tied
  uncertainties included: the lower index first), `matcher_cost` 1e-5 and
  `classification_loss` (efg_tpu's scatter order, see
  `test_padding_slot_overwrites_matched_query_zero`);
- `predict_instance`, `predict_panoptic`, `predict_semantic` on
  predictions made from a seed: integer maps and keep sets equal, scores
  1e-5;
- `modeling/post_processing.py`'s three functions.

efg_tpu's functions are jitted once each (eagerly every jnp op compiles).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.models import mask2former as JM
from efg_tpu.modeling import post_processing as JPP
from efg_tpu.ops.ms_deform_attn import ms_deform_attn_sample as j_msda
from efg_tpu_torch.models import mask2former as TM
from efg_tpu_torch.modeling import post_processing as TPP
from efg_tpu_torch.ops.ms_deform_attn import ms_deform_attn_sample as t_msda
from efg_tpu_torch.ops.resize import resize

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

RESIZE_TOL = 1e-6  # of each output's max
MSDA_TOL = 1e-5
LOSS_TOL = 1e-5
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


# the masked attention's shrinks of 1/4-scale logits (64 → 8, 16, 32 at a
# 256 canvas), the pixel decoder's 2× nearest, the APE's cubic both ways,
# and sizes that are no multiple of each other
RESIZE_CASES = [
    ((2, 3, 64, 64), (2, 3, 8, 8), "bilinear"),
    ((2, 3, 64, 64), (2, 3, 16, 16), "bilinear"),
    ((2, 3, 64, 64), (2, 3, 32, 32), "bilinear"),
    ((2, 3, 50, 62), (2, 3, 7, 13), "bilinear"),
    ((3, 10, 10), (3, 37, 23), "bilinear"),
    ((2, 8, 9, 4), (2, 16, 18, 4), "nearest"),
    ((2, 4, 7, 5), (2, 4, 15, 11), "nearest"),
    ((1, 56, 56, 6), (1, 30, 41, 6), "cubic"),
    ((1, 56, 56, 6), (1, 70, 90, 6), "cubic"),
]


@pytest.mark.parametrize("shape,out,method", RESIZE_CASES,
                         ids=[f"{m}-{s}-{o}" for s, o, m in RESIZE_CASES])
def test_resize_matches_jax_image_resize(shape, out, method):
    x = np.random.RandomState(len(shape) + out[-1]).randn(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize(_t(x), out, method).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    assert _rel(got, want) <= RESIZE_TOL


def test_resize_is_not_f_interpolate():
    """The three ways the helper differs from F.interpolate's defaults, each
    seen: antialiased bilinear shrink, Keys a = −0.5, half-pixel nearest."""
    import torch.nn.functional as F

    x = torch.from_numpy(np.random.RandomState(0).randn(1, 1, 32, 32).astype(np.float32))
    assert (resize(x, (1, 1, 8, 8), "bilinear")
            - F.interpolate(x, size=(8, 8), mode="bilinear")).abs().max() > 1e-2
    assert (resize(x, (1, 1, 45, 45), "cubic")
            - F.interpolate(x, size=(45, 45), mode="bicubic")).abs().max() > 1e-3
    y = torch.arange(5.0).reshape(1, 1, 1, 5)
    assert resize(y, (1, 1, 1, 3), "nearest").flatten().tolist() == [0.0, 2.0, 4.0]
    assert F.interpolate(y, size=(1, 3), mode="nearest").flatten().tolist() == [0.0, 1.0, 3.0]


@pytest.mark.parametrize("spread", [(0.0, 1.0), (-0.3, 1.3)], ids=["inside", "outside"])
def test_ms_deform_attn_matches(spread):
    rs = np.random.RandomState(3)
    shapes = [(8, 10), (4, 5), (2, 3)]
    vals = [rs.randn(2, h, w, 16).astype(np.float32) for h, w in shapes]
    loc = rs.uniform(*spread, (2, 7, 4, 3, 4, 2)).astype(np.float32)
    aw = rs.rand(2, 7, 4, 3, 4).astype(np.float32)
    aw /= aw.sum((3, 4), keepdims=True)
    want = jax.jit(lambda v, l, a: j_msda(v, l, a, num_heads=4))(
        [jnp.asarray(v) for v in vals], jnp.asarray(loc), jnp.asarray(aw))
    got = t_msda([_t(v) for v in vals], _t(loc), _t(aw), num_heads=4)
    assert _rel(got, want) <= MSDA_TOL
    if spread[0] < 0:  # some taps fall outside every level
        assert (loc < 0).any() and (loc > 1).any()


def test_sample_points_match():
    rs = np.random.RandomState(4)
    masks = rs.randn(2, 3, 9, 11).astype(np.float32)
    pts = rs.uniform(-0.1, 1.1, (40, 2)).astype(np.float32)
    want = jax.jit(jax.vmap(jax.vmap(lambda m: JM._sample_points(m, jnp.asarray(pts)))))(
        jnp.asarray(masks))
    assert _rel(TM.sample_points(_t(masks), _t(pts)), want) <= 1e-6
    each = rs.uniform(0, 1, (6, 40, 2)).astype(np.float32)
    want = jax.jit(jax.vmap(JM._sample_points))(jnp.asarray(masks.reshape(6, 9, 11)),
                                                jnp.asarray(each))
    assert _rel(TM.sample_points_each(_t(masks.reshape(6, 9, 11)), _t(each)), want) <= 1e-6


def test_uncertainty_points_keep_efg_tpu_order_on_ties():
    """Candidates from efg_tpu's draw; half the logits tie (a constant
    map), so the kept set depends on top_k's lower-index-first order."""
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 3, 8, 8).astype(np.float32)
    logits[0, 1] = 0.25  # every candidate of this pair ties
    cand = rs.uniform(0, 1, (2, 3, 48, 2)).astype(np.float32)
    rnd = rs.uniform(0, 1, (6, 4, 2)).astype(np.float32)
    kw = dict(num_points=16, oversample_ratio=3.0, importance_sample_ratio=0.75)
    want = jax.jit(lambda l, c, r: JM.uncertainty_point_coords(
        jax.random.key(0), l, cand=c, rand_points=r, **kw))(
        jnp.asarray(logits), jnp.asarray(cand), jnp.asarray(rnd))
    got = TM.uncertainty_point_coords(None, _t(logits), cand=_t(cand), rand_points=_t(rnd), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matcher_cost_matches():
    """Two images of 4 GT slots, 3 and 2 of them valid (1e8 elsewhere)."""
    rs = np.random.RandomState(6)
    cls = rs.randint(0, 5, (2, 4)).astype(np.int32)
    ok = np.arange(4)[None] < np.array([[3], [2]])
    prob = jax.nn.softmax(jnp.asarray(rs.randn(2, 7, 6).astype(np.float32)), -1)
    pred_pts = rs.randn(2, 7, 30).astype(np.float32)
    gt_pts = rs.rand(2, 4, 30).astype(np.float32)
    kw = dict(w_ce=2.0, w_bce=5.0, w_dice=5.0, num_points=30)
    want = jax.jit(jax.vmap(lambda *a: JM.matcher_cost(*a, **kw)))(
        prob, jnp.asarray(pred_pts), jnp.asarray(cls), jnp.asarray(gt_pts), jnp.asarray(ok))
    got = TM.matcher_cost(_t(np.asarray(prob)), _t(pred_pts), _t(cls), _t(gt_pts), _t(ok), **kw)
    w = np.asarray(want)
    assert np.array_equal(w == 1e8, got.numpy() == 1e8)
    assert _rel(np.where(w == 1e8, 0, got.numpy()), np.where(w == 1e8, 0, w)) <= LOSS_TOL


def test_padding_slot_overwrites_matched_query_zero():
    """efg_tpu's `classification_loss` scatters every GT slot's target into
    its query, padding slots (assignment −1 → query 0, target no-object)
    included: where query 0 is matched and a padding slot follows, the
    padding slot's write stands (XLA's CPU scatter applies them in
    order), so a matched query 0 is trained toward no-object. The port
    keeps that order on either device (`query_targets`)."""
    rs = np.random.RandomState(7)
    logits = rs.randn(2, 6, 5).astype(np.float32)
    assign = np.array([[0, 3, -1, -1], [2, 0, 5, -1]], np.int32)
    ok = assign >= 0
    gcls = np.array([[1, 2, 0, 0], [3, 1, 2, 0]], np.int32)
    want = float(jax.jit(lambda *a: JM.classification_loss(*a, num_classes=4, no_obj=0.1))(
        jnp.asarray(logits), jnp.asarray(assign), jnp.asarray(ok), jnp.asarray(gcls)))
    got = float(TM.classification_loss(_t(logits), _t(assign).long(), _t(ok), _t(gcls).long(),
                                       num_classes=4, no_obj=0.1))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    tgt = TM.query_targets(_t(assign).long(), _t(ok), _t(gcls).long(), 6, 4)
    # image 0: query 0 is matched to class 1 and reads no-object (4); image
    # 1: its padding slot comes last, after the slot that matched query 0
    assert tgt.tolist() == [[4, 4, 4, 2, 4, 4], [4, 4, 3, 4, 4, 2]]


def _preds(seed, d=2, b=2, q=6, c=5, h=12, w=10):
    rs = np.random.RandomState(seed)
    cls = rs.randn(d, b, q, c + 1).astype(np.float32) * 3
    masks = rs.randn(d, b, q, h, w).astype(np.float32) * 2
    return cls, masks


def _jpreds(cls, masks):
    return dict(cls_logits=jnp.asarray(cls), mask_logits=jnp.asarray(masks))


def test_predict_instance_matches():
    cls, masks = _preds(8)
    cfg = dict(num_classes=5)
    want = jax.jit(lambda p: JM.predict_instance(p, model_cfg=cfg, top_k=12))(_jpreds(cls, masks))
    got = TM.predict_instance(dict(cls_logits=_t(cls), mask_logits=_t(masks)), model_cfg=cfg,
                              top_k=12)
    for k in ("labels", "masks", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert _rel(got["scores"], want["scores"]) <= SCORE_TOL


def test_predict_instance_ties_keep_lower_index():
    """Tied class probabilities (two identical queries): jax.lax.top_k keeps
    the lower flat index first, and so does the port."""
    cls, masks = _preds(9)
    cls[:, :, 3] = cls[:, :, 1]
    masks[:, :, 3] = masks[:, :, 1]
    cfg = dict(num_classes=5)
    want = jax.jit(lambda p: JM.predict_instance(p, model_cfg=cfg, top_k=30))(_jpreds(cls, masks))
    got = TM.predict_instance(dict(cls_logits=_t(cls), mask_logits=_t(masks)), model_cfg=cfg,
                              top_k=30)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(want["masks"]))


def test_predict_panoptic_and_semantic_match():
    """Queries with confident classes and blob masks, so that some pass the
    0.8 score threshold and the overlap filter."""
    cls, masks = _preds(10)
    rs = np.random.RandomState(12)
    cls[..., :5] *= 2.5
    masks = masks * 0.5 - 4.0
    for d, b, q in np.ndindex(masks.shape[:3]):
        y, x = rs.randint(0, 8), rs.randint(0, 7)
        masks[d, b, q, y:y + 5, x:x + 4] += 8.0
    cfg = dict(num_classes=5)
    for thr in (0.8, 0.3):
        want = jax.jit(lambda p: JM.predict_panoptic(p, model_cfg=cfg,
                                                     object_mask_threshold=thr))(
            _jpreds(cls, masks))
        got = TM.predict_panoptic(dict(cls_logits=_t(cls), mask_logits=_t(masks)),
                                  model_cfg=cfg, object_mask_threshold=thr)
        for k in ("pan_seg", "pan_labels", "pan_keep"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert _rel(got["pan_scores"], want["pan_scores"]) <= SCORE_TOL
        assert np.asarray(want["pan_keep"]).any() and (np.asarray(want["pan_seg"]) > 0).any()
    want = jax.jit(lambda p: JM.predict_semantic(p, model_cfg=cfg))(_jpreds(cls, masks))
    got = TM.predict_semantic(dict(cls_logits=_t(cls), mask_logits=_t(masks)), model_cfg=cfg)
    assert _rel(got, want) <= SCORE_TOL


def test_post_processing_matches():
    rs = np.random.RandomState(11)
    m = rs.rand(5, 14, 14).astype(np.float32)
    xy = rs.uniform(0, 60, (5, 2, 2)).astype(np.float32)
    boxes = np.concatenate([xy.min(1), xy.max(1)], axis=1)
    want = jax.jit(lambda m, b: JPP.paste_masks_in_image(m, b, (50, 70)))(
        jnp.asarray(m), jnp.asarray(boxes))
    got = TPP.paste_masks_in_image(_t(m), _t(boxes), (50, 70))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).sum() > 0
    logits = rs.randn(3, 20, 30).astype(np.float32)
    want = jax.jit(lambda x: JPP.sem_seg_postprocess(x, (55, 83)))(jnp.asarray(logits))
    assert _rel(TPP.sem_seg_postprocess(_t(logits), (55, 83)), want) <= RESIZE_TOL
    bb = rs.uniform(-20, 300, (2, 7, 4)).astype(np.float32)
    want = jax.jit(lambda b: JPP.detector_postprocess(b, 1.7, (120, 150)))(jnp.asarray(bb))
    # XLA divides by the scale as a product with its reciprocal: an ulp apart
    assert _rel(TPP.detector_postprocess(_t(bb), 1.7, (120, 150)), want) <= RESIZE_TOL
