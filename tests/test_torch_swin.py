"""Port parity of the Swin Transformer backbone (efg_tpu_torch vs efg_tpu)
at a small width (embed 32, depths 2/2/2/2, heads 2/2/4/4, window 7, APE
from a 112-pixel pretrain grid) on 90×75 images: maps that are no
multiple of the window (padded and cut back, the shifted blocks' mask
over the padded map), odd merges (23×19 → 12×10), SAME patch padding and
the cubic APE resize. efg_tpu's variables come from `jax.eval_shape` of
its init with every leaf drawn from a numpy seed and are carried across
by `utils/jax_import.py`; its forward is jitted once.

- the four output maps within 1e-4 of each one's max;
- `import_swin` of a seeded mmdet-format state dict (APE as [1, C, H, W],
  the merges' (00, 10, 01, 11) channel order, buffers that are dropped,
  a key with no counterpart) into both packages: the port's import equals
  efg_tpu's mapped across bit for bit, the same counts and skipped keys,
  and the imported forwards agree at 1e-4; the official layout's APE
  ([1, N, C]) lands the same;
- drop path: train-mode forwards from one generator seed draw the same
  masks, another seed other masks, eval mode none.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.modeling.backbones.swin import SwinTransformer as JSwin
from efg_tpu.utils import torch_import as JTI
from efg_tpu_torch.modeling.backbones.swin import SwinTransformer as TSwin
from efg_tpu_torch.utils import torch_import as TTI
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_conquer_ops import fill_variables

KW = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=7, ape=True,
          pretrain_img_size=112)
OUT_TOL = 1e-4  # of each output's max


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def swin():
    images = np.random.RandomState(0).uniform(-1, 1, (2, 90, 75, 3)).astype(np.float32)
    jm = JSwin(**KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(images), False))
    variables = _np(fill_variables(shapes, 3))
    forward = jax.jit(lambda v, x: jm.apply(v, x, False))
    return images, variables, forward


def _port(variables):
    tm = TSwin(**KW)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return tm.eval()


def _port_forward(tm, images):
    with torch.no_grad():
        return {k: v.permute(0, 2, 3, 1).numpy()
                for k, v in tm(torch.from_numpy(images).permute(0, 3, 1, 2)).items()}


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= OUT_TOL, (what, err)


def test_forward_matches(swin):
    images, variables, forward = swin
    want = forward(variables, jnp.asarray(images))
    got = _port_forward(_port(variables), images)
    assert {k: v.shape[1:3] for k, v in got.items()} == {
        "res2": (23, 19), "res3": (12, 10), "res4": (6, 5), "res5": (3, 3)}
    for k in want:
        _close(got[k], want[k], k)


def mmdet_swin(seed, kw=KW, ape_layout="mmdet"):
    """A seeded reference-format Swin state dict (mmdet key names and
    layouts) for `kw`, with the buffers a checkpoint carries and one key
    that maps nowhere."""
    g = torch.Generator().manual_seed(seed)
    c = kw["embed_dim"]
    sd = {"patch_embed.proj.weight": torch.randn(c, 3, 4, 4, generator=g) * 0.2,
          "patch_embed.proj.bias": torch.randn(c, generator=g) * 0.1,
          "patch_embed.norm.weight": 1 + 0.1 * torch.randn(c, generator=g),
          "patch_embed.norm.bias": 0.1 * torch.randn(c, generator=g),
          "head.weight": torch.randn(10, 8 * c, generator=g)}
    side = kw["pretrain_img_size"] // 4
    ape = 0.1 * torch.randn(1, c, side, side, generator=g)
    sd["absolute_pos_embed"] = ape if ape_layout == "mmdet" else \
        ape.permute(0, 2, 3, 1).reshape(1, side * side, c)
    ws = kw["window_size"]
    dim = c
    for i, (depth, heads) in enumerate(zip(kw["depths"], kw["num_heads"])):
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            for n in ("norm1", "norm2"):
                sd[f"{p}.{n}.weight"] = 1 + 0.1 * torch.randn(dim, generator=g)
                sd[f"{p}.{n}.bias"] = 0.1 * torch.randn(dim, generator=g)
            sd[f"{p}.attn.relative_position_bias_table"] = 0.2 * torch.randn(
                (2 * ws - 1) ** 2, heads, generator=g)
            sd[f"{p}.attn.relative_position_index"] = torch.zeros(ws * ws, ws * ws,
                                                                  dtype=torch.long)
            for n, (o, ii) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                               ("mlp.fc1", (4 * dim, dim)), ("mlp.fc2", (dim, 4 * dim))):
                sd[f"{p}.{n}.weight"] = torch.randn(o, ii, generator=g) / ii ** 0.5
                sd[f"{p}.{n}.bias"] = 0.1 * torch.randn(o, generator=g)
            if j % 2:
                sd[f"{p}.attn_mask"] = torch.zeros(4, ws * ws, ws * ws)
        sd[f"norm{i}.weight"] = 1 + 0.1 * torch.randn(dim, generator=g)
        sd[f"norm{i}.bias"] = 0.1 * torch.randn(dim, generator=g)
        if i < len(kw["depths"]) - 1:
            sd[f"layers.{i}.downsample.norm.weight"] = 1 + 0.1 * torch.randn(4 * dim, generator=g)
            sd[f"layers.{i}.downsample.norm.bias"] = 0.1 * torch.randn(4 * dim, generator=g)
            sd[f"layers.{i}.downsample.reduction.weight"] = torch.randn(
                2 * dim, 4 * dim, generator=g) / (4 * dim) ** 0.5
            dim *= 2
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("ape_layout", ["mmdet", "official"])
def test_import_swin_matches(swin, ape_layout):
    images, variables, forward = swin
    sd = mmdet_swin(5, ape_layout=ape_layout)
    jvars, jn, jskipped = JTI.import_swin(sd, variables, prefix="")
    tm = _port(variables)
    tn, tskipped = TTI.import_swin(sd, tm, prefix="")
    assert (tn, sorted(tskipped)) == (jn, sorted(jskipped)) and tskipped == ["head.weight"]
    want_sd = flax_to_state_dict(TSwin(**KW), jvars)
    got_sd = tm.state_dict()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    # every tensor of the port's Swin came from the file
    assert tn - sum(k.endswith(("relative_position_index", "attn_mask")) for k in sd) == len(got_sd)
    want = forward(jvars, jnp.asarray(images))
    got = _port_forward(tm, images)
    for k in want:
        _close(got[k], want[k], k)


def test_import_swin_under_a_prefix():
    """Mask2Former's `backbone` prefix, on a module holding the Swin there."""
    tm = torch.nn.Module()
    tm.backbone = TSwin(**KW)
    sd = mmdet_swin(6)
    n, skipped = TTI.import_swin(sd, tm, prefix="backbone")
    assert skipped == ["head.weight"]
    assert torch.equal(tm.backbone.stage1_block0.fc1.weight,
                       torch.from_numpy(sd["layers.1.blocks.0.mlp.fc1.weight"]))
    perm = TTI._merge_perm(4 * 32)
    assert torch.equal(tm.backbone.merge0.reduction.weight,
                       torch.from_numpy(sd["layers.0.downsample.reduction.weight"][:, perm]))


def test_drop_path_draws_from_the_generator():
    kw = dict(KW, drop_path_rate=0.5)
    tm = TSwin(**kw, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))

    def run(seed, train=True):
        tm.train(train)
        with torch.no_grad():
            gen = None if seed is None else torch.Generator().manual_seed(seed)
            return tm(x, gen)["res5"]

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(None, train=False), run(7, train=False))
    assert not torch.equal(run(7), run(None, train=False))
