"""Port parity: reference CenterPoint checkpoints imported into the port
(efg_tpu_torch vs efg_tpu), and double-flip test-time augmentation.

A reference-format state dict of the tiny CenterPoint (its key list
written here from the reference's module layout, in both spconv weight
layouts, with a stride-1 deblock conv, a stride-2 deblock deconv and
two-conv SepHeads) goes through the port's `import_centerpoint_voxelnet`
and through efg_tpu's followed by `utils/jax_import.py`: equal tensor for
tensor, the same counts and nothing skipped; through `.pth` (with DDP's
`module.` prefix) and `.pkl` files; and the imported model's forward and
double-flip forward against efg_tpu's in f32 at 1e-5. Zoo URIs resolve to
efg_tpu's URLs and take a file from the download cache."""

import hashlib
import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.models import centerpoint as JCP
from efg_tpu.modeling.backbones import rpn as JRPN
from efg_tpu.modeling.heads import center_head as JCH
from efg_tpu.ops import sparse as S
from efg_tpu.utils import catalog as JCAT
from efg_tpu.utils import torch_import as JTI
from efg_tpu_torch.models import centerpoint as TCP
from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.utils import catalog as TCAT
from efg_tpu_torch.utils import torch_import as TTI
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_centerpoint import KW, _cloud
from test_torch_sparse_net import fill_variables
from test_torch_train import TRAIN_KW, _F32Jnp

# f32 activations, and voxel and stage capacities above the clouds'
# occupancy (TRAIN_KW): efg_tpu's XLA rule9 misreads a tap of a full stage
# (ROADMAP queue 3), which moved a head map by 3e-3 at KW's capacities
F32_KW = dict(TRAIN_KW, act_dtype="")
HEADS = dict(KW["common_heads"])  # name → (channels, num_conv)
BEV_CHANNELS = 256  # 128 × the 2 z rows left of the 41-row grid after the four downsamples


def _bn(sd, prefix, c, rs):
    sd[f"{prefix}.weight"] = rs.uniform(0.6, 1.4, c)
    sd[f"{prefix}.bias"] = rs.uniform(-0.2, 0.2, c)
    sd[f"{prefix}.running_mean"] = rs.uniform(-0.2, 0.2, c)
    sd[f"{prefix}.running_var"] = rs.uniform(0.6, 1.4, c)
    sd[f"{prefix}.num_batches_tracked"] = np.array(7, np.int64)


def _kernel(rs, shape, fan_in):
    return rs.randn(*shape) * np.sqrt(2.0 / fan_in)


def reference_state_dict(seed, layout="spconv2", num_input=5, neck=None, num_classes=3):
    """A reference CenterPoint VoxelNet state dict (numpy, f32): trunk
    SpMiddleResNetFHD (`conv_input`, `conv1`-`conv4` SparseSequentials:
    [0] strided conv, [1] BN, [2] ReLU, [3]-[4] SparseBasicBlocks;
    `extra_conv`), neck `blocks.i` ([0] ZeroPad, [1] conv, [2] BN, [3] ReLU,
    then conv / BN / ReLU a layer) and `deblocks.i` ([0] ConvTranspose2d at
    stride > 1, else Conv2d; [1] BN), head `shared_conv` and
    `tasks.0.<head>` ([0] conv, [1] BN, [2] ReLU, [3] final conv)."""
    neck = dict(neck or KW["neck_cfg"])
    rs = np.random.RandomState(seed)
    sd = {}

    def sparse(name, cin, cout, k):
        w = _kernel(rs, (cout, *k, cin), cin * int(np.prod(k)))  # spconv 2.x
        sd[name] = w if layout == "spconv2" else w.transpose(1, 2, 3, 4, 0)

    def block(prefix, c):
        for j in (1, 2):
            sparse(f"{prefix}.conv{j}.weight", c, c, (3, 3, 3))
            sd[f"{prefix}.conv{j}.bias"] = rs.uniform(-0.1, 0.1, c)
            _bn(sd, f"{prefix}.bn{j}", c, rs)

    def conv(name, cin, cout, k, bias=False):
        sd[f"{name}.weight"] = _kernel(rs, (cout, cin, k, k), cin * k * k)
        if bias:
            sd[f"{name}.bias"] = rs.uniform(-0.1, 0.1, cout)

    sparse("backbone.conv_input.0.weight", num_input, 16, (3, 3, 3))
    _bn(sd, "backbone.conv_input.1", 16, rs)
    block("backbone.conv1.0", 16)
    block("backbone.conv1.1", 16)
    for s, (cin, cout) in enumerate(((16, 32), (32, 64), (64, 128)), start=2):
        sparse(f"backbone.conv{s}.0.weight", cin, cout, (3, 3, 3))
        _bn(sd, f"backbone.conv{s}.1", cout, rs)
        block(f"backbone.conv{s}.3", cout)
        block(f"backbone.conv{s}.4", cout)
    sparse("backbone.extra_conv.0.weight", 128, 128, (3, 1, 1))
    _bn(sd, "backbone.extra_conv.1", 128, rs)

    cin = BEV_CHANNELS
    for i, (n_layers, nf) in enumerate(zip(neck["layer_nums"], neck["ds_num_filters"])):
        conv(f"neck.blocks.{i}.1", cin, nf, 3)
        _bn(sd, f"neck.blocks.{i}.2", nf, rs)
        for j in range(n_layers):
            conv(f"neck.blocks.{i}.{4 + 3 * j}", nf, nf, 3)
            _bn(sd, f"neck.blocks.{i}.{5 + 3 * j}", nf, rs)
        stride, uf = neck["us_layer_strides"][i], neck["us_num_filters"][i]
        if stride > 1:  # ConvTranspose2d [in, out, k, k]
            sd[f"neck.deblocks.{i}.0.weight"] = _kernel(rs, (nf, uf, stride, stride), nf)
        else:
            conv(f"neck.deblocks.{i}.0", nf, uf, 1)
        _bn(sd, f"neck.deblocks.{i}.1", uf, rs)
        cin = nf

    conv("center_head.shared_conv.0", sum(neck["us_num_filters"]), 64, 3, bias=True)
    _bn(sd, "center_head.shared_conv.1", 64, rs)
    for name, (ch, num_conv) in {**HEADS, "hm": (num_classes, 2)}.items():
        assert num_conv == 2
        conv(f"center_head.tasks.0.{name}.0", 64, 64, 3, bias=True)
        _bn(sd, f"center_head.tasks.0.{name}.1", 64, rs)
        conv(f"center_head.tasks.0.{name}.3", 64, ch, 3, bias=True)
    return {k: (v.astype(np.float32) if v.dtype != np.int64 else v) for k, v in sd.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    """efg_tpu's tiny VoxelNet in f32 (sparse compute, RPN and head convs),
    its variable shapes, and its jitted eval-mode apply."""
    pts, mask = _cloud(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(JRPN, "jnp", _F32Jnp())
        mp.setattr(JCH, "jnp", _F32Jnp())
        jm = JCP.VoxelNet(sparse_backend="xla", **F32_KW)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(pts),
                                                jnp.asarray(mask), False))
        apply = jax.jit(lambda v, p, m: jm.apply(v, p, m, False))
        yield jm, fill_variables(shapes, 0), apply


def _port_model():
    return TCP.VoxelNet(device="cpu", **F32_KW)


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("layout", ["spconv2", "spconv1"])
def test_import_matches_jax_import(jax_model, layout):
    """Every tensor the port imports equals efg_tpu's import mapped by
    `utils/jax_import.py`; both count the same tensors and skip none."""
    _, variables, _ = jax_model
    sd = reference_state_dict(1, layout)
    jvars, jn, jskipped = JTI.import_centerpoint_voxelnet(sd, variables, sparse_layout=layout)
    tm = _port_model()
    before = _state(tm)
    n, skipped = TTI.import_centerpoint_voxelnet(sd, tm, sparse_layout=layout)
    assert (n, skipped) == (jn, jskipped) == (len(sd), [])
    want = flax_to_state_dict(_port_model(), jvars)
    got = tm.state_dict()
    assert set(want) == set(got)
    for k, v in got.items():
        assert not torch.equal(v, before[k]), k
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    # the layout maps by kind: deconv as it is, sparse weights re-laid out
    np.testing.assert_array_equal(got["neck.deblock1_deconv.weight"].numpy(),
                                  sd["neck.deblocks.1.0.weight"])
    np.testing.assert_array_equal(got["neck.deblock0_conv.weight"].numpy(),
                                  sd["neck.deblocks.0.0.weight"])
    w = sd["backbone.conv2.0.weight"]
    w = w if layout == "spconv1" else w.transpose(1, 2, 3, 4, 0)
    np.testing.assert_array_equal(got["backbone.down1.weight"].numpy(), w.reshape(27, 16, 32))


def test_import_skips_what_does_not_fit(jax_model):
    """An unknown key and a tensor of another shape are skipped and named,
    in both packages, and leave the model's tensor as it was."""
    _, variables, _ = jax_model
    sd = reference_state_dict(2)
    sd["reader.unused.weight"] = np.zeros(3, np.float32)
    sd["center_head.shared_conv.0.bias"] = np.zeros(65, np.float32)
    _, jn, jskipped = JTI.import_centerpoint_voxelnet(sd, variables)
    tm = _port_model()
    before = tm.head.shared_conv.bias.detach().clone()
    n, skipped = TTI.import_centerpoint_voxelnet(sd, tm)
    assert (n, sorted(skipped)) == (jn, sorted(jskipped))
    assert sorted(skipped) == ["center_head.shared_conv.0.bias", "reader.unused.weight"]
    assert torch.equal(tm.head.shared_conv.bias, before)


def test_checkpoint_files_round_trip(tmp_path):
    """`.pth` (a trainer checkpoint with DDP's `module.` prefix and
    non-tensor entries) and `.pkl` (numpy arrays) load to the same dict,
    and import to the same model."""
    sd = reference_state_dict(3)
    pth, pkl = tmp_path / "ref.pth", tmp_path / "ref.pkl"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
                "meta": {"epoch": 36}, "optimizer": {"lr": 0.003}}, pth)
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd, "__author__": "ref"}, f)
    loaded = {}
    for path in (pth, pkl):
        got = TTI.strip_prefix(TTI.load_state_dict(str(path)))
        want = JTI.strip_prefix(JTI.load_state_dict(str(path)))
        assert set(got) == set(want) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], sd[k])
        tm = _port_model()
        assert TTI.import_centerpoint_voxelnet(TTI.load_state_dict(str(path)), tm) == (len(sd), [])
        loaded[path.suffix] = tm.state_dict()
    for k, v in loaded[".pth"].items():
        assert torch.equal(v, loaded[".pkl"][k]), k


def _f32_port(monkeypatch, sd):
    monkeypatch.setattr(K, "COMPUTE_DTYPE", torch.float32)
    tm = _port_model()
    for m in tm.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.dtype = None
    assert TTI.import_centerpoint_voxelnet(sd, tm) == (len(sd), [])
    return tm.eval()


def _maps(preds):
    return [{k: np.asarray(v, np.float32) for k, v in t.items()} for t in preds]


def _close(got, want, tol=1e-5):
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0])
    for k, w in want[0].items():
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(got[0][k], w, rtol=0, atol=tol * scale, err_msg=k)


def test_imported_forward_matches_jax(jax_model, monkeypatch):
    """The imported model serves like efg_tpu's with its imported
    variables: head maps in f32 within 1e-5 of each map's range."""
    _, variables, apply = jax_model
    sd = reference_state_dict(4)
    jvars, _, _ = JTI.import_centerpoint_voxelnet(sd, variables)
    pts, mask = _cloud(5, bsz=1)
    want = _maps(apply(jvars, jnp.asarray(pts), jnp.asarray(mask)))
    tm = _f32_port(monkeypatch, sd)
    with torch.no_grad():
        got = _maps([{k: v.numpy() for k, v in t.items()}
                     for t in tm(torch.from_numpy(pts), torch.from_numpy(mask))])
    _close(got, want)


class _JittedModule:
    """efg_tpu's module with its apply jitted (one compile for the four
    flipped clouds' forwards of `forward_double_flip`)."""

    def __init__(self, apply):
        self._apply = apply

    def apply(self, variables, points, mask, train):
        assert train is False
        return self._apply(variables, points, mask)


def test_double_flip_matches_jax(jax_model, monkeypatch):
    """`forward_double_flip` against efg_tpu's on the same weights and
    cloud, f32 within 1e-5 of each map's range; `vel` is checked with a
    hand-made map set through the un-flip arithmetic alone."""
    _, variables, apply = jax_model
    sd = reference_state_dict(6)
    jvars, _, _ = JTI.import_centerpoint_voxelnet(sd, variables)
    pts, mask = _cloud(7, bsz=1)
    want = _maps(JCP.forward_double_flip(_JittedModule(apply), jvars, jnp.asarray(pts),
                                         jnp.asarray(mask)))
    tm = _f32_port(monkeypatch, sd)
    with torch.no_grad():
        got = _maps([{k: v.numpy() for k, v in t.items()} for t in
                     TCP.forward_double_flip(tm, torch.from_numpy(pts), torch.from_numpy(mask))])
    _close(got, want)
    single = _maps(apply(jvars, jnp.asarray(pts), jnp.asarray(mask)))
    assert not np.allclose(single[0]["hm"], want[0]["hm"])  # the flips changed the maps

    # `vel` (no config here has it): both merges on the same four map sets
    rs = np.random.RandomState(8)
    maps = [[{k: rs.randn(2, 4, 5, c).astype(np.float32) for k, c in
              (("reg", 2), ("rot", 2), ("vel", 2), ("hm", 3))}] for _ in range(4)]
    jmaps, tmaps = iter(maps), iter(maps)

    class _JFixed:
        def apply(self, variables, points, mask, train):
            return [{k: jnp.asarray(v) for k, v in next(jmaps)[0].items()}]

    class _TFixed(torch.nn.Module):
        def forward(self, points, mask):
            return [{k: torch.from_numpy(v) for k, v in next(tmaps)[0].items()}]

    jwant = _maps(JCP.forward_double_flip(_JFixed(), None, jnp.zeros((2, 8, 5)),
                                          jnp.ones((2, 8), bool)))
    tgot = _maps([{k: v.numpy() for k, v in t.items()} for t in TCP.forward_double_flip(
        _TFixed(), torch.zeros(2, 8, 5), torch.ones(2, 8, dtype=torch.bool))])
    _close(tgot, jwant)


def test_zoo_uris_resolve_from_the_cache(tmp_path, monkeypatch):
    """`catalog://` and `detectron2://` resolve to efg_tpu's URLs and cache
    paths; a file put in the cache is used as it is (no network)."""
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    name = "ImageNetPretrained/MSRA/R-50"
    assert TCAT.ModelCatalog.get(name) == JCAT.ModelCatalog.get(name)
    with pytest.raises(KeyError):
        TCAT.ModelCatalog.get("no/such/entry")
    for uri in (f"catalog://{name}", "detectron2://ref/centerpoint_voxelnet.pkl"):
        url = TCAT.ModelCatalog.get(name) if uri.startswith("catalog") else \
            JCAT.Detectron2Handler.S3_DETECTRON2_PREFIX + uri[len("detectron2://"):]
        cached = os.path.join(str(tmp_path), "downloads",
                              hashlib.sha1(url.encode()).hexdigest()[:16], os.path.basename(url))
        os.makedirs(os.path.dirname(cached), exist_ok=True)
        with open(cached, "wb") as f:
            f.write(b"cached " + uri.encode())
        assert TCAT.PathManager.get_local_path(uri) == cached == JCAT.PathManager.get_local_path(uri)
        with TCAT.PathManager.open(uri, "rb") as f:
            assert f.read() == b"cached " + uri.encode()
        assert TCAT.HTTPURLHandler().get_local_path(url) == cached
