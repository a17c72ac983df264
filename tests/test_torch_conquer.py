"""Port parity: the whole ConQueR / Voxel-DETR serving slice at a tiny size
(efg_tpu_torch vs efg_tpu): hidden 32 (GroupNorm's 32 groups), 4 heads, 1
encoder and 2 decoder layers, 16 queries, 1024-point clouds, stage caps
(1536, 1024, 512, 256) above occupancy. res4 still runs at 256 channels, so
the gather-GEMM's 256-wide plain path is on it.

efg_tpu's model is initialised through `jax.eval_shape` (its eager init
takes 85 s here) and every leaf is drawn from a numpy seed, so no
box-attention offset or weight is left at its zero init; its apply is
jitted, once with the sparse convs in bf16 and once in f32
(`sparse.set_compute_dtype`, beside the port's `K.COMPUTE_DTYPE`) with
denoising queries in front of the top-k ones (`dn_ref`, `dn_attn_mask`),
in one module fixture."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.models import conquer as JCQ
from efg_tpu.models import voxel_detr as JVD
from efg_tpu.modeling.readers.voxel_reader import dynamic_mean_vfe as j_vfe
from efg_tpu.ops import sparse as JS
from efg_tpu_torch.engine.trainer import eval_step
from efg_tpu_torch.models import conquer as TCQ
from efg_tpu_torch.models import voxel_detr as TVD
from efg_tpu_torch.modeling.readers.voxel_reader import dynamic_mean_vfe as t_vfe
from efg_tpu_torch.ops import box_attention as TBA
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_conquer_ops import _close, fill_variables

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PC = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)
VOX = (0.1, 0.1, 0.15)
KW = dict(pc_range=PC, voxel_size=VOX, max_voxels=2048, resnet_caps=(1536, 1024, 512, 256),
          hidden_dim=32, num_head=4, enc_layers=1, dec_layers=2, dim_feedforward=64,
          num_queries=16, num_classes=3)
MODEL_CFG = dict(pc_range=PC, voxel_size=VOX)
CONTRAS_DIM = 32
# bf16 sparse convs: one rounding flip upstream moves a value by ~2^-8 of
# its scale and the flips compound through 18 convs, the encoder's bf16
# window op and the decoder (the trunk alone: test_torch_sparse_net's 1e-2)
BF16_TOL = 3e-2
F32_TOL = 1e-4  # f32 sparse convs, the BEV maps: summation order only
# f32 sparse convs, the transformer: both packages round the window ops' V
# (and the encoder's A) to bf16, and a last-bit difference in the f32
# projections before them flips some of those roundings (2.6e-4 observed)
F32_MODEL_TOL = 1e-3


def _cloud(seed, bsz=2, n=1024, objects=16, radius=0.25):
    """Points in `objects` blobs of about `radius` m, as returns gather on
    the objects of a LiDAR sweep: every stage's occupancy stays under its
    cap (a uniform cloud fills res2-res4). The last 50 points of sample 1
    are padding."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(-6.5, 6.5, (bsz, objects, 3))
    centres[..., 2] = rs.uniform(-1, 2, (bsz, objects))
    which = rs.randint(0, objects, (bsz, n))
    xyz = (np.take_along_axis(centres, which[..., None].repeat(3, -1), 1)
           + rs.randn(bsz, n, 3) * radius * np.array([1, 1, 0.5]))
    pts = np.concatenate([xyz, rs.uniform(0, 1, (bsz, n, 2))], -1)
    mask = np.ones((bsz, n), bool)
    mask[1, -50:] = False
    return pts.astype(np.float32), mask


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _denoising(seed=12, p=8, q=16):
    """dn_ref [2, P, 10] (noised boxes + one-hot labels) and the mask
    [P+Q, P+Q] (True = may attend) of ConQueR's training forward: groups
    of 4 denoising queries that see only themselves, the top-k queries
    only each other."""
    rs = np.random.RandomState(seed)
    dn_ref = np.concatenate([rs.uniform(0.1, 0.9, (2, p, 7)), np.eye(3)[rs.randint(0, 3, (2, p))]],
                            -1).astype(np.float32)
    group = np.where(np.arange(p + q) >= p, 99, np.arange(p + q) // 4)
    return dn_ref, group[:, None] == group[None, :]


@pytest.fixture(scope="module")
def models():
    """(efg_tpu module, its variables, the port's module with them loaded,
    the cloud, efg_tpu's outputs and intermediates in bf16 and in f32)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pts, mask = _cloud(0)
    jm = JCQ.ConQueRModule(detr=JVD.VoxelDETR(**KW), contras_dim=CONTRAS_DIM, num_classes=3)
    args = (jnp.asarray(pts), jnp.asarray(mask))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args, False))
    variables = _numpy(fill_variables(shapes, 11))
    dn_ref, dn_mask = (jnp.asarray(a) for a in _denoising())

    def run(**dn):
        out, inter = jax.jit(lambda v: jm.apply(v, *args, False, capture_intermediates=True,
                                                **dn))(variables)
        return ({k: np.asarray(v) for k, v in out.items() if k != "memory_levels" and v is not None},
                _numpy(inter["intermediates"]["detr"]["backbone"]["__call__"][0]))

    want = {"bf16": run()}
    JS.set_compute_dtype(jnp.float32)
    try:
        want["f32"] = run(dn_ref=dn_ref, dn_attn_mask=dn_mask)
    finally:
        JS.set_compute_dtype(jnp.bfloat16)
    tm = TCQ.ConQueRModule(TVD.VoxelDETR(**KW, device="cpu"), contras_dim=CONTRAS_DIM)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    tm.eval()
    yield dict(jm=jm, variables=variables, tm=tm, pts=pts, mask=mask, want=want)
    torch.set_num_threads(n)


def _port(models, dtype, **dn):
    """The port's outputs and BEV maps, its sparse convs in `dtype` and its
    gather window op's A in f32 (efg_tpu's CPU `_dot_dtype`)."""
    tm = models["tm"]
    bev = {}
    hook = tm.detr.backbone.register_forward_hook(lambda m, i, o: bev.update(o))
    old = (K.COMPUTE_DTYPE, TBA.GATHER_DOT_DTYPE)
    K.COMPUTE_DTYPE, TBA.GATHER_DOT_DTYPE = dtype, torch.float32
    try:
        with torch.no_grad():
            out = tm(torch.from_numpy(models["pts"]), torch.from_numpy(models["mask"]), **dn)
    finally:
        K.COMPUTE_DTYPE, TBA.GATHER_DOT_DTYPE = old
        hook.remove()
    return out, bev


@pytest.fixture(scope="module")
def port_bf16(models):
    return _port(models, torch.bfloat16)


@pytest.fixture(scope="module")
def port_f32(models):
    dn_ref, dn_mask = (torch.from_numpy(a) for a in _denoising())
    return _port(models, torch.float32, dn_ref=dn_ref, dn_attn_mask=dn_mask)


def test_voxels_match(models):
    """Voxel coords and validity bit for bit, mean features to f32."""
    pts, mask = models["pts"], models["mask"]
    kw = dict(pc_range=PC, voxel_size=VOX, max_voxels=2048, num_input_features=5)
    wf, wc, wv = (np.asarray(a) for a in j_vfe(jnp.asarray(pts), jnp.asarray(mask), **kw))
    gf, gc, gv = t_vfe(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_allclose(gf.numpy(), wf, rtol=0, atol=1e-6)
    assert 500 < int(wv.sum()) < 4096


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_bev_levels_match(models, port_bf16, port_f32, mode):
    """res2-res4 BEV maps [B, H, W, C·D] (res4: 256 channels × 2 planes)."""
    _, want = models["want"][mode]
    _, got = port_bf16 if mode == "bf16" else port_f32
    assert set(got) == set(want) == {"res2", "res3", "res4"}
    assert got["res4"].shape == want["res4"].shape == (2, 10, 10, 512)
    for k in want:
        _close(got[k], want[k], tol=BF16_TOL if mode == "bf16" else F32_TOL, what=k)


def _probs(logits):
    return 1 / (1 + np.exp(-np.asarray(logits, np.float64)[..., 0]))


def _topk_agrees(got, want, k):
    """The top-k sets agree outside the tie band: twice the largest score
    difference between the packages (random weights leave clusters of
    scores within 1e-7 of each other, whose order is either's)."""
    pw, pg = _probs(want["enc_logits"]), _probs(got["enc_logits"].numpy())
    band = 2 * float(np.abs(pw - pg).max())
    for b in range(pw.shape[0]):
        s = np.sort(pw[b])[::-1]
        idx = set(got["topk_idx"][b].tolist())
        assert set(np.nonzero(pw[b] > s[k - 1] + band)[0].tolist()) <= idx, b
        assert not set(np.nonzero(pw[b] < s[k] - band)[0].tolist()) & idx, b
        assert set(want["topk_idx"][b].tolist()) >= set(np.nonzero(pw[b] > s[k - 1] + band)[0].tolist())


def _by_cell(dec, topk_idx, b):
    """One sample's decoder outputs [D, Q, ·] with the query slots ordered
    by their cell: the decoder is equivariant in the slots, so a tie taken
    in another order permutes its outputs alike."""
    return dec[:, b][:, np.argsort(topk_idx[b], kind="stable")]


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_whole_model_matches(models, port_bf16, port_f32, mode):
    """The encoder's proposal logits and boxes over every cell, the top-k
    queries (outside the tie band), and both decoder layers' logits and
    boxes, slot by slot in cell order, for every sample whose top-k set is
    efg_tpu's (in f32, every sample, and the denoising queries' outputs)."""
    want, _ = models["want"][mode]
    got, _ = port_bf16 if mode == "bf16" else port_f32
    tol = BF16_TOL if mode == "bf16" else F32_MODEL_TOL
    for k in ("enc_logits", "enc_boxes"):
        _close(got[k], want[k], tol=tol, what=k)
    assert got["topk_idx"].shape == want["topk_idx"].shape == (2, 16)
    _topk_agrees(got, want, 16)
    assert got["dec_logits"].shape == (2, 2, 16, 3) and got["dec_boxes"].shape == (2, 2, 16, 7)
    gi, wi = got["topk_idx"].numpy(), want["topk_idx"]
    same = [b for b in range(2) if set(gi[b].tolist()) == set(wi[b].tolist())]
    assert same == [0, 1] or mode == "bf16"
    for b in same:
        for k in ("dec_logits", "dec_boxes"):
            _close(_by_cell(got[k].numpy(), gi, b), _by_cell(want[k], wi, b), tol=tol,
                   what=f"{k}[{b}]")
    if mode == "bf16":
        assert got["dn_logits"] is None and got["dn_boxes"] is None
        return
    assert got["dn_logits"].shape == (2, 2, 8, 3) and got["dn_boxes"].shape == (2, 2, 8, 7)
    for k in ("dn_logits", "dn_boxes"):
        _close(got[k], want[k], tol=tol, what=k)


@pytest.mark.parametrize("source", ["model", "q200"])
def test_predict_matches(models, source):
    """`predict` on the same decoder outputs, the tiny model's (Q×C = 48
    scores, all kept) and random ones with 200 queries (the top 300 of 600
    taken): scores, labels, boxes and the order, exactly as efg_tpu's."""
    if source == "model":
        preds, _ = models["want"]["f32"]
        preds = {k: preds[k] for k in ("dec_logits", "dec_boxes")}
    else:
        rs = np.random.RandomState(13)
        preds = dict(dec_logits=rs.randn(2, 2, 200, 3).astype(np.float32) * 3,
                     dec_boxes=rs.rand(2, 2, 200, 7).astype(np.float32))
    want = JVD.predict({k: jnp.asarray(v) for k, v in preds.items()}, model_cfg=MODEL_CFG)
    got = TVD.predict({k: torch.tensor(v) for k, v in preds.items()}, model_cfg=MODEL_CFG)
    assert got["scores"].shape == (2, 48 if source == "model" else 300)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _close(got["scores"], want["scores"], tol=1e-6, what="scores")
    _close(got["box3d"], want["box3d"], tol=1e-6, what="box3d")


def test_eval_step_is_predict(models):
    """The ModelDef that `make_model_def` builds: eval_step = predict of
    the module's outputs; for training it carries the custom loss and the
    EMA hooks, whose state is a real copy of the decoder's parameters,
    kept outside the module's parameters."""
    md = TCQ.make_model_def({**KW, "pc_range": PC, "voxel_size": VOX},
                            dict(MODEL_CFG, contrastive={"dim": CONTRAS_DIM, "mom": 0.5}),
                            device="cpu")
    md.module.load_state_dict(models["tm"].state_dict())
    batch = dict(points=torch.from_numpy(models["pts"]), points_mask=torch.from_numpy(models["mask"]))
    out = eval_step(md, batch)
    with torch.no_grad():
        ref = TVD.predict(md.module(**md.apply_args(batch)), model_cfg=MODEL_CFG)
    assert set(out) == {"box3d", "scores", "labels", "valid"}
    for k in out:
        assert torch.equal(out[k], ref[k]), k
    assert out["box3d"].shape == (2, 48, 7) and int(out["labels"].min()) >= 1
    assert callable(md.custom_loss) and callable(md.ema_init) and callable(md.ema_update)
    dec = dict(md.module.detr.decoder.named_parameters())
    ema = md.ema_init(md.module)
    assert set(ema) == set(dec) and all(torch.equal(ema[n], p) for n, p in dec.items())
    assert all(e.data_ptr() != dec[n].data_ptr() for n, e in ema.items())
    params = {id(p) for p in md.module.parameters()}
    assert not any(id(e) in params for e in ema.values())
    before = {n: e.clone() for n, e in ema.items()}
    with torch.no_grad():
        for p in dec.values():
            p.add_(1.0)
    md.ema_update(ema, md.module)
    assert all(torch.equal(ema[n], before[n] * 0.5 + dec[n] * (1.0 - 0.5)) for n in ema)


def test_weight_import_is_strict(models):
    """Every flax leaf is used once, the projector / predictor and the MHA's
    3-D kernels included; a missing leaf, an extra one or a wrong shape
    raises."""
    v, tm = models["variables"], models["tm"]
    sd = flax_to_state_dict(tm, v)
    assert set(sd) == set(tm.state_dict())
    mha = v["params"]["detr"]["decoder"]["dec0"]["self_attn"]
    assert mha["query"]["kernel"].shape == (32, 4, 8) and mha["out"]["kernel"].shape == (4, 8, 32)
    np.testing.assert_array_equal(sd["detr.decoder.dec0.self_attn.query.weight"].numpy(),
                                  mha["query"]["kernel"].reshape(32, 32).T)
    np.testing.assert_array_equal(sd["projector.fc0.weight"].numpy(),
                                  v["params"]["projector"]["fc0"]["kernel"].T)

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, v)  # a copy of the dicts
        fn(tree)
        return tree

    with pytest.raises(KeyError, match="not found"):
        flax_to_state_dict(tm, edited(lambda t: t["params"]["predictor"].pop("fc1")))
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(tm, edited(lambda t: t["params"]["detr"].update(extra={"w": np.ones(2)})))
    wrong = edited(lambda t: t["params"]["detr"]["decoder"]["dec1"]["self_attn"]["key"].update(
        kernel=np.zeros((32, 32), np.float32)))
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(tm, wrong)
    wrong = edited(lambda t: t["params"]["detr"]["input_gn_p3"].update(scale=np.ones(16, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(tm, wrong)
