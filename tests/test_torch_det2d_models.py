"""Port parity of the 2D detectors as whole models (efg_tpu_torch vs
efg_tpu) at a small size: depth-18 trunks on 64×64 images, batch 2, 5
classes, f32.

efg_tpu's variables come from `jax.eval_shape` of its init with every
leaf drawn from a numpy seed (`fill_variables`; an eager flax init of a
ResNet takes tens of seconds here), AutoAssign's `sigma` and FCOS's
`scales` set positive, and are carried into the port by
`utils/jax_import.py`. Each model's efg_tpu step is jitted once:

- FCOS (freeze_at 0) and RetinaNet (freeze_at 1): the forward's outputs
  within 1e-4 of their max, the loss parts at 1e-5, every gradient leaf
  within 1e-4 of its max (a frozen stage's zeros included);
- AutoAssign (freeze_at 2, mu / sigma): three f32 steps of clip +
  D2_SGD + WarmupMultiStep, efg_tpu's `build_optimizer` chain
  (clip_by_global_norm, masked add_decayed_weights, sgd) against the
  port's `train_step`: step 1's outputs and gradients as above, the loss
  parts of every step at 1e-5, and the weight-decay mask equal leaf by
  leaf (mu / sigma decayed, FrozenBN's scale and the head's scales not,
  the frozen stem's kernels decayed);
- one R-50 `ResNet` forward (bottleneck blocks, FrozenBN) at 1e-4 of the
  max of each output;
- the torchvision R-50 import: a seeded torchvision-style state dict put
  through efg_tpu's `import_torchvision_resnet` and `jax_import` equals
  the port's direct `import_torchvision_resnet` bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
import optax

from efg_tpu.modeling.backbones.resnet import ResNet as JResNet
from efg_tpu.models import autoassign as JAA
from efg_tpu.models import fcos as JF
from efg_tpu.models import retinanet as JR
from efg_tpu.solver import optimizers as JOPT
from efg_tpu.solver import schedulers as JSCHED
from efg_tpu.utils import torch_import as JTI
from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.engine.trainer import init_state, train_step
from efg_tpu_torch.modeling.backbones.resnet import ResNet as TResNet
from efg_tpu_torch.models import autoassign as TAA
from efg_tpu_torch.models import fcos as TF
from efg_tpu_torch.models import retinanet as TR
from efg_tpu_torch.solver import optimizers as TOPT
from efg_tpu_torch.solver import schedulers as TSCHED
from efg_tpu_torch.utils import torch_import as TTI
from efg_tpu_torch.utils.jax_import import flax_names, flax_to_state_dict

from test_torch_conquer_ops import fill_variables
from test_torch_det2d_ops import gt_2d

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

C = 5
STRIDES = (8, 16, 32, 64, 128)
CFG = dict(num_classes=C, fpn_strides=list(STRIDES), center_sampling_radius=1.5)
OUT_TOL = 1e-4   # of each output's max: f32, summation order only
GRAD_TOL = 1e-4  # of each gradient leaf's max
LOSS_TOL = 1e-5
SCHED = dict(type="WarmupMultiStep", lr=0.01, milestones=[2], gamma=0.1, warmup_iters=2,
             warmup_factor=0.1)
OPTIM = dict(type="D2_SGD", lr=0.01, momentum=0.9, weight_decay=0.0001)
CLIP = dict(enabled=True, clip_type="norm", params=dict(max_norm=10.0))
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, bsz=2, size=64):
    return np.random.RandomState(seed).uniform(-1, 1, (bsz, size, size, 3)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(module, images, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.asarray(images), True))
    v = _np(fill_variables(shapes, seed))
    p = v["params"]
    if "sigma" in p:
        p["sigma"] = np.random.RandomState(seed).uniform(0.6, 1.4, p["sigma"].shape).astype(np.float32)
    if "head" in p and "scales" in p["head"]:
        p["head"]["scales"] = np.linspace(0.8, 1.2, 5).astype(np.float32)
    return v


def _close(got, want, tol, what):
    got = np.zeros_like(np.asarray(want)) if got is None else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-6)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|Δ| {err} > {tol} · {scale}"


def _losses_close(got, want, what=""):
    for k in want:
        w = float(want[k])
        g = float(torch.as_tensor(got[k]).detach())
        assert abs(g - w) <= LOSS_TOL * max(abs(w), 1.0), (what, k, g, w)


def _batches():
    boxes, cls, mask = gt_2d(3)
    j = dict(gt_boxes2d=jnp.asarray(boxes), gt_classes2d=jnp.asarray(cls), gt_mask2d=jnp.asarray(mask))
    t = dict(gt_boxes2d=torch.from_numpy(boxes), gt_classes2d=torch.from_numpy(cls),
             gt_mask2d=torch.from_numpy(mask))
    return j, t


def _jax_steps(jm, jloss, variables, images, batch, steps, tx=None):
    """efg_tpu's forward, losses and gradients (and with `tx` its updates)
    for `steps` steps, one jitted step."""
    bstats = variables["batch_stats"]

    def loss_fn(params):
        preds = jm.apply({"params": params, "batch_stats": bstats}, jnp.asarray(images), True)
        losses = jloss(preds, batch, model_cfg=CFG)
        return losses["loss"], (losses, {k: v for k, v in preds.items() if k != "shapes"})

    @jax.jit
    def step(params, opt_state):
        (_, (losses, preds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        if tx is None:
            return params, opt_state, losses, preds, grads
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, losses, preds, grads

    params = variables["params"]
    opt_state = tx.init(params) if tx is not None else None
    out = []
    for _ in range(steps):
        params, opt_state, losses, preds, grads = step(params, opt_state)
        out.append(_np((losses, preds, grads)))
    return out


def _port_grads_like(tm, variables, grads):
    """efg_tpu's gradient tree in the port's parameter layout."""
    sd = flax_to_state_dict(tm, {"params": grads, "batch_stats": variables["batch_stats"]})
    return {n: sd[n].numpy() for n, _ in tm.named_parameters()}


def _model_run(name):
    """Both packages on the same weights and batch: FCOS (freeze_at 0) and
    RetinaNet (freeze_at 1) one forward and backward; AutoAssign
    (freeze_at 2) three steps of clip + D2_SGD + WarmupMultiStep, efg_tpu's
    `build_optimizer` chain against the port's `train_step`. Returns the
    readings the tests hold against each other."""
    jb, tb = _batches()
    if name == "autoassign":
        images = _images(2)
        jm = JAA.AutoAssign(num_classes=C, depth=18, freeze_at=2)
        tm = TAA.AutoAssign(num_classes=C, depth=18, freeze_at=2, device="cpu")
        variables = _variables(jm, images, 9)
        lr_j, _ = JSCHED.build_scheduler(SCHED)
        tx = JOPT.build_optimizer(OPTIM, lr_j, None, grad_clip_cfg=CLIP)
        want = _jax_steps(jm, JAA.compute_loss, variables, images, jb, STEPS, tx)
        tm.load_state_dict(flax_to_state_dict(tm, variables))
        lr_t, _ = TSCHED.build_scheduler(SCHED)
        ttx = TOPT.build_optimizer(OPTIM, lr_t, None, grad_clip_cfg=CLIP, module=tm)
        captured, grads, losses = [], None, []

        def loss_fn(preds, b):  # mu / sigma are the parameters themselves: copy them
            captured.append({k: v.detach().clone() if torch.is_tensor(v) else v
                             for k, v in preds.items()})
            return TAA.compute_loss(preds, b, model_cfg=CFG)

        md = ModelDef(tm, lambda b: dict(images=b["images"]), loss_fn)
        state = init_state(md, ttx)
        batch = dict(tb, images=torch.from_numpy(images))
        for i in range(STEPS):
            losses.append({k: float(v) for k, v in train_step(md, ttx, state, batch).items()})
            if i == 0:  # this step's gradients, before the next step clears them
                grads = {n: None if p.grad is None else p.grad.numpy().copy()
                         for n, p in tm.named_parameters()}
        return dict(tm=tm, variables=variables, want=want, losses=losses, preds=captured[0],
                    grads=grads, tx=ttx, state=state)
    images = _images(1)
    if name == "fcos":
        jm = JF.FCOS(num_classes=C, depth=18, freeze_at=0)
        tm = TF.FCOS(num_classes=C, depth=18, freeze_at=0, device="cpu")
        jloss, tloss = JF.compute_loss, TF.compute_loss
    else:
        jm = JR.RetinaNet(num_classes=C, depth=18, freeze_at=1)
        tm = TR.RetinaNet(num_classes=C, depth=18, freeze_at=1, device="cpu")
        jloss, tloss = JR.compute_loss, TR.compute_loss
    variables = _variables(jm, images, 7)
    want = _jax_steps(jm, jloss, variables, images, jb, 1)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    tm.train()
    preds = tm(torch.from_numpy(images))
    losses = tloss(preds, tb, model_cfg=CFG)
    losses["loss"].backward()
    return dict(tm=tm, variables=variables, want=want,
                losses=[{k: float(v.detach()) for k, v in losses.items()}], preds=preds,
                grads={n: None if p.grad is None else p.grad.numpy()
                       for n, p in tm.named_parameters()})


@pytest.fixture(scope="module")
def runs():
    """`_model_run` of each model, made when a test first asks for it."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = _model_run(name)
        return made[name]

    return get


OUTPUTS = [(m, k) for m in ("fcos", "retinanet", "autoassign")
           for k in ("logits", "deltas", "centerness") if not (m == "retinanet" and k == "centerness")]


@pytest.mark.parametrize("name,key", OUTPUTS)
def test_forward_outputs(runs, name, key):
    r = runs(name)
    _close(r["preds"][key].detach().numpy(), r["want"][0][1][key], OUT_TOL, key)


@pytest.mark.parametrize("name,step", [("fcos", 0), ("retinanet", 0), ("autoassign", 0),
                                       ("autoassign", 1), ("autoassign", 2)])
def test_loss_parts(runs, name, step):
    """Step 0's losses; AutoAssign's after each of its D2 SGD updates."""
    r = runs(name)
    _losses_close(r["losses"][step], r["want"][step][0], f"{name} step {step}")


GRAD_PARTS = [(m, part) for m in ("fcos", "retinanet", "autoassign")
              for part in ("backbone.", "fpn.", "head.")] + [("autoassign", "")]


@pytest.mark.parametrize("name,part", GRAD_PARTS)
def test_step1_gradients(runs, name, part):
    """Every gradient leaf under `part` ("" : AutoAssign's own mu / sigma)
    within GRAD_TOL of its max, a frozen stage's zeros included."""
    r = runs(name)
    want = _port_grads_like(r["tm"], r["variables"], r["want"][0][2])
    names = [n for n in want if n.startswith(part)] if part else ["mu", "sigma"]
    for n in names:
        _close(r["grads"][n], want[n], GRAD_TOL, f"grad {n}")


@pytest.mark.parametrize("name,frozen", [("fcos", ()), ("retinanet", ("backbone.stem_",)),
                                         ("autoassign", ("backbone.stem_", "backbone.res2_"))])
def test_frozen_stages(runs, name, frozen):
    """freeze_at cuts the gradient where efg_tpu's stop_gradient does: no
    parameter before it gets one."""
    got = [n for n, g in runs(name)["grads"].items() if g is None]
    assert bool(got) == bool(frozen) and all(n.startswith(frozen) for n in got), got


def test_decay_mask_matches_efg_tpu(runs):
    """The D2 SGD mask leaf by leaf against efg_tpu's on its flax names."""
    r = runs("autoassign")
    jmask = JOPT._norm_bias_mask(r["variables"]["params"])
    names = flax_names(r["tm"])
    for (key, _), decayed in zip(r["tm"].named_parameters(), r["tx"].decay):
        node = jmask
        for part in names[key][1]:
            node = node[part]
        assert decayed == bool(node), key


@pytest.mark.parametrize("key,decayed", [
    ("mu", True), ("sigma", True), ("backbone.stem_conv1.weight", True),
    ("head.cls_conv0.weight", True), ("head.scales", False),
    ("backbone.res3_block0.norm1.weight", False), ("head.cls_pred.bias", False),
    ("head.cls_gn0.weight", False)])
def test_decay_mask_cases(runs, key, decayed):
    """AutoAssign's [C, 2] prior decays (efg_tpu's mask reads rank > 1),
    the frozen stem's kernel too; norm scales, biases and the head's
    per-level scales do not."""
    r = runs("autoassign")
    assert dict(zip((k for k, _ in r["tm"].named_parameters()), r["tx"].decay))[key] == decayed


def test_sgd_state_after_three_steps(runs):
    r = runs("autoassign")
    assert r["state"].step == STEPS and r["state"].opt_state.count == STEPS
    assert any(float(t.abs().max()) > 0 for t in r["state"].opt_state.trace)


@pytest.fixture(scope="module")
def resnet50():
    images = _images(4)
    jm = JResNet(depth=50, freeze_at=0)
    variables = _variables(jm, images, 5)
    want = _np(jax.jit(lambda v, x: jm.apply(v, x, False))(variables, jnp.asarray(images)))
    tm = TResNet(depth=50, freeze_at=0)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    return got, want


@pytest.mark.parametrize("stage", ["res3", "res4", "res5"])
def test_resnet50_forward(resnet50, stage):
    got, want = resnet50
    assert set(got) == set(want) == {"res3", "res4", "res5"}
    _close(got[stage].permute(0, 2, 3, 1).numpy(), want[stage], OUT_TOL, stage)


def torchvision_resnet50_state_dict(seed):
    """A torchvision-format R-50 state dict (conv1 / bn1, layer1-4 with
    downsample.0 / .1, fc) of seeded values, num_batches_tracked included."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = torch.randn(o, i, k, k, generator=g) / (i * k * k) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{name}.running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, n in enumerate((3, 4, 6, 3)):
        width = 64 * 2**s
        for b in range(n):
            pre = f"layer{s + 1}.{b}"
            conv(f"{pre}.conv1", width, cin, 1)
            bn(f"{pre}.bn1", width)
            conv(f"{pre}.conv2", width, width, 3)
            bn(f"{pre}.bn2", width)
            conv(f"{pre}.conv3", width * 4, width, 1)
            bn(f"{pre}.bn3", width * 4)
            if b == 0:
                conv(f"{pre}.downsample.0", width * 4, cin, 1)
                bn(f"{pre}.downsample.1", width * 4)
            cin = width * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


class _WithBackbone(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = TResNet(depth=50)


@pytest.fixture(scope="module")
def r50_file(tmp_path_factory):
    sd = torchvision_resnet50_state_dict(11)
    path = str(tmp_path_factory.mktemp("r50") / "r50.pth")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)  # DDP prefix
    return sd, path


def test_torchvision_resnet_import_matches(r50_file):
    sd, path = r50_file
    loaded = TTI.load_state_dict(path)

    jm = JResNet(depth=50)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jvars = {c: {"backbone": zeros[c]} for c in ("params", "batch_stats")}
    jvars, jn, jskipped = JTI.import_torchvision_resnet(JTI.load_state_dict(path), jvars, "backbone")

    tm = _WithBackbone()
    n, skipped = TTI.import_torchvision_resnet(loaded, tm, "backbone")
    assert (n, sorted(skipped)) == (jn, sorted(jskipped))
    assert n == sum(1 for k in sd if not k.startswith("fc.") and "num_batches" not in k)
    assert sorted(skipped) == sorted(k for k in sd if "num_batches" in k)
    want = flax_to_state_dict(tm, jvars)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(tm.backbone.res5_block2.conv3.weight, sd["layer4.2.conv3.weight"])


def test_torchvision_import_without_a_resnet(r50_file):
    """A model with no ResNet under the prefix takes nothing and skips
    every key but fc's."""
    sd, path = r50_file
    other = torch.nn.Module()
    other.head = torch.nn.Linear(3, 3)
    n, skipped = TTI.import_torchvision_resnet(TTI.load_state_dict(path), other, "backbone")
    assert n == 0 and len(skipped) == sum(1 for k in sd if not k.startswith("fc."))
