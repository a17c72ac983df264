"""Port parity: the whole CenterPoint-VoxelNet serving slice at small size
(efg_tpu_torch vs efg_tpu): head maps under shared weights, predict /
rotated NMS on identical maps, and the weight mapper."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.linen as fnn
import jax.numpy as jnp

from efg_tpu.models import centerpoint as JCP
from efg_tpu.ops import nms as JNMS
from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.engine.trainer import eval_step
from efg_tpu_torch.models import centerpoint as TCP
from efg_tpu_torch.modeling.backbones.rpn import ConvTranspose2d
from efg_tpu_torch.ops import nms as TNMS
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_sparse_net import fill_variables

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

TASKS = ({"num_classes": 3, "class_names": ["VEHICLE", "PEDESTRIAN", "CYCLIST"]},)
COMMON_HEADS = (("reg", (2, 2)), ("height", (1, 2)), ("dim", (3, 2)), ("rot", (2, 2)))
KW = dict(
    pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 4.0),  # grid 128×128×40 → BEV 16×16
    voxel_size=(0.1, 0.1, 0.15),
    max_voxels=2048,
    stage_caps=(2048, 2048, 2048, 2048),  # above occupancy
    act_dtype="bfloat16",
    tasks=TASKS,
    common_heads=COMMON_HEADS,
    neck_cfg=(("layer_nums", (1, 1)), ("ds_layer_strides", (1, 2)),
              ("ds_num_filters", (32, 64)), ("us_layer_strides", (1, 2)),
              ("us_num_filters", (32, 32))),
)
MODEL_CFG = dict(pc_range=KW["pc_range"], voxel_size=KW["voxel_size"],
                 tasks=[dict(t) for t in TASKS], common_heads=COMMON_HEADS)
# The random-weight boxes of neighbouring cells overlap little, so the IoU
# threshold sits at 0.3 for NMS to suppress some; post > pre exercises the
# padding of the kept set.
POST_CFG = dict(
    post_center_limit_range=[-10, -10, -5, 10, 10, 5],
    nms=dict(nms_pre_max_size=128, nms_post_max_size=256, nms_iou_threshold=0.3),
    score_threshold=0.1,
    out_size_factor=8,
)


def _cloud(seed, bsz=2, n=3000):
    rs = np.random.RandomState(seed)
    r = np.minimum(rs.exponential(2.5, (bsz, n)), 6.0) + 0.5
    th = rs.uniform(-np.pi, np.pi, (bsz, n))
    pts = np.stack([r * np.cos(th), r * np.sin(th), rs.randn(bsz, n) * 0.8], -1)
    pts = np.concatenate([pts, rs.uniform(0, 1, (bsz, n, 2))], -1).astype(np.float32)
    mask = np.ones((bsz, n), bool)
    mask[:, -100:] = False
    return pts, mask


@pytest.fixture(scope="module")
def slice_outputs():
    """Head maps of both packages on the same cloud and weights."""
    pts, mask = _cloud(0)
    jm = JCP.VoxelNet(sparse_backend="xla", **KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(pts), jnp.asarray(mask), False))
    variables = fill_variables(shapes, 1)
    want = jax.jit(lambda v, p, m: jm.apply(v, p, m, False))(variables, jnp.asarray(pts), jnp.asarray(mask))
    want = [{k: np.array(v, np.float32) for k, v in t.items()} for t in want]

    tm = TCP.VoxelNet(device="cpu", **KW)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    md = ModelDef(tm, lambda b: dict(points=b["points"], points_mask=b["points_mask"]))
    got = eval_step(md, dict(points=torch.from_numpy(pts), points_mask=torch.from_numpy(mask)))
    got = [{k: v.float().numpy() for k, v in t.items()} for t in got]
    return want, got


def test_head_maps_match_jax(slice_outputs):
    """bf16 tolerance, relative to each map's range: the trunk and the bf16
    dense convs round at the same places in both packages, and a last-bit
    difference upstream flips some bf16 roundings downstream. Observed:
    ≤ 0.4% of max|map|."""
    want, got = slice_outputs
    assert len(want) == len(got) == 1
    assert set(want[0]) == set(got[0]) == {"reg", "height", "dim", "rot", "hm"}
    for name, w in want[0].items():
        g = got[0][name]
        assert g.shape == w.shape == (2, 16, 16, {"reg": 2, "height": 1, "dim": 3, "rot": 2, "hm": 3}[name])
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-2 * scale, err_msg=name)


def test_predict_matches_jax_on_same_maps(slice_outputs):
    """Both packages decode + NMS the SAME head maps: keep sets and labels
    exact, boxes to 1e-5 (f32 decode arithmetic in both)."""
    maps, _ = slice_outputs
    want = JCP.predict([{k: jnp.asarray(v) for k, v in maps[0].items()}],
                       post_cfg=POST_CFG, model_cfg=MODEL_CFG)
    got = TCP.predict([{k: torch.from_numpy(v) for k, v in maps[0].items()}],
                      post_cfg=POST_CFG, model_cfg=MODEL_CFG)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["box3d"].numpy(), np.asarray(want["box3d"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=1e-6, atol=1e-6)
    # NMS suppressed some of the 2 × 128 candidates
    assert 0 < int(got["valid"].sum()) < 2 * POST_CFG["nms"]["nms_pre_max_size"]


def _boxes(seed, n=160):
    """Crowded boxes with heavy overlap, ties in score, and invalid rows."""
    rs = np.random.RandomState(seed)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rs.uniform(-4, 4, (n, 2))
    boxes[:, 2] = rs.uniform(-1, 1, n)
    boxes[:, 3:6] = rs.uniform(0.5, 3.0, (n, 3))
    boxes[:, 6] = rs.uniform(-np.pi, np.pi, n)
    scores = np.round(rs.uniform(0, 1, n), 2).astype(np.float32)  # many ties
    scores[rs.uniform(size=n) < 0.2] = JNMS.NEG_INF
    return boxes, scores


@pytest.mark.parametrize("pre_max,post_max", [(128, 48), (256, 200)])
def test_rotated_nms_keep_sets_match_jax(pre_max, post_max):
    bs = [_boxes(s) for s in (0, 1)]
    got_idx, got_valid = TNMS.rotated_nms(
        torch.from_numpy(np.stack([b for b, _ in bs])), torch.from_numpy(np.stack([s for _, s in bs])),
        iou_threshold=0.3, pre_max=pre_max, post_max=post_max)
    for i, (b, s) in enumerate(bs):
        idx, valid = JNMS.rotated_nms(jnp.asarray(b), jnp.asarray(s), iou_threshold=0.3,
                                      pre_max=pre_max, post_max=post_max)
        np.testing.assert_array_equal(got_valid[i].numpy(), np.asarray(valid))
        np.testing.assert_array_equal(got_idx[i].numpy()[np.asarray(valid)], np.asarray(idx)[np.asarray(valid)])


def test_circle_nms_keep_sets_match_jax():
    b, s = _boxes(2)
    got_idx, got_valid = TNMS.circle_nms(torch.from_numpy(b[None, :, :2]), torch.from_numpy(s[None]),
                                         min_radius=1.0, pre_max=128, post_max=40)
    idx, valid = JNMS.circle_nms(jnp.asarray(b[:, :2]), jnp.asarray(s), min_radius=1.0,
                                 pre_max=128, post_max=40)
    np.testing.assert_array_equal(got_valid[0].numpy(), np.asarray(valid))
    np.testing.assert_array_equal(got_idx[0].numpy(), np.asarray(idx))


def test_conv_transpose_mapping_flips_the_kernel():
    """flax ConvTranspose does not flip its kernel and torch's does: the
    mapper's spatial flip makes the two agree (2×2, stride 2)."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 5, 8).astype(np.float32)
    jm = fnn.ConvTranspose(6, (2, 2), strides=(2, 2), padding="VALID", use_bias=False)
    variables = {"params": {"kernel": rs.randn(2, 2, 8, 6).astype(np.float32)}}
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = ConvTranspose2d(8, 6, 2)

    tm = Wrap()
    tm.load_state_dict(flax_to_state_dict(tm, {"params": {"up": variables["params"]}}))
    # the port's deconv runs in bf16 like the flax RPN's; compare in f32 here
    with torch.no_grad():
        got = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), tm.up.weight, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    flat = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(variables["params"]["kernel"].transpose(2, 3, 0, 1).copy()), stride=2)
    assert np.abs(flat.permute(0, 2, 3, 1).numpy() - want).max() > 0.1  # unflipped is wrong


def test_weight_mapper_is_strict():
    tm = TCP.VoxelNet(device="cpu", **KW)
    pts, mask = _cloud(1)
    jm = JCP.VoxelNet(sparse_backend="xla", **KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(pts), jnp.asarray(mask), False))
    variables = fill_variables(shapes, 2)
    sd = flax_to_state_dict(tm, variables)
    assert set(sd) == set(tm.state_dict())
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["head"]["stray"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(tm, extra)
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["batch_stats"]["backbone"]["bn_input"]
    with pytest.raises(KeyError, match="not found"):
        flax_to_state_dict(tm, missing)


def test_entry_point_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCP.VoxelNet(**KW)
