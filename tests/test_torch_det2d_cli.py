"""The 2D experiments through the port's CLI on the CPU, and the 2D losses
under data parallelism.

- The three synthetic experiments (`detection.2d/synthetic/{fcos,
  retinanet,autoassign}.synth.res50`) as written but for 64×64 images and
  4 frames: `task=train`, 2 iterations of R-50 + D2_SGD + WarmupMultiStep
  through each experiment's port `net.py`, then `COCOEvaluator` on the val
  split; FCOS also resumes from its step-1 checkpoint bit for bit
  (module, SGD trace, step, the iteration-2 record).
- The three COCO experiments as written on a COCO-format fixture
  (`test_torch_det2d_data.write_coco`, canvas cut to 96×128, the data root
  by dotlist): `model.weights` a seeded torchvision R-50 `.pth`, imported
  into the backbone by the default `resnet` format, one iteration; FCOS's
  then `task=val`.
- Each model's `compute_loss` on two gloo ranks, a sample each, summed
  over the ranks, against one process on both samples within 1e-6; the
  predictions' gradients too.
"""

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.engine import launch
from efg_tpu_torch.engine import trainer as T
from efg_tpu_torch.models import autoassign as TAA
from efg_tpu_torch.models import fcos as TF
from efg_tpu_torch.models import retinanet as TR
from efg_tpu_torch.parallel import ddp
from efg_tpu_torch.utils import distributed as comm

ROOT = Path(__file__).resolve().parents[1]
SYNTH = "detection.2d/synthetic/{}.synth.res50"
COCO = {"fcos": "detection.2d/coco/fcos/fcos.res50.fpn.coco.800size.1x",
        "retinanet": "detection.2d/coco/retina_net/retinanet.res50.fpn.coco.multiscale.1x",
        "autoassign": "detection.2d/coco/auto_assign/auto_assign.res50.fpn.coco.800size.1x"}
SMALL_SYNTH = ["dataset.num_frames=4", "dataset.image_size=64",
               "dataset.processors.train[2].PadImage.height=64",
               "dataset.processors.train[2].PadImage.width=64",
               "dataset.processors.val[1].PadImage.height=64",
               "dataset.processors.val[1].PadImage.width=64"]
MODELS = {"fcos": TF, "retinanet": TR, "autoassign": TAA}
DDP_TOL = 1e-6
WORLD = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capture_evaluations(monkeypatch):
    results = []
    evaluate = T.DefaultTrainer.evaluate

    def wrapped(self, evaluators=None):
        results.append(evaluate(self, evaluators))
        return results[-1]

    monkeypatch.setattr(T.DefaultTrainer, "evaluate", wrapped)
    return results


def _records(out):
    return [r for r in (json.loads(line) for line in open(out / "metrics.json")) if "loss" in r]


def _check_coco_results(res):
    assert {"coco/AP", "coco/AP50", "coco/AP75", "coco/AR100"} <= set(res)
    assert all(0.0 <= v <= 1.0 for k, v in res.items() if k in ("coco/AP50", "coco/AR100"))


def _synthetic_run(base, name):
    """The synthetic experiment through the CLI (2 iterations, a checkpoint
    after each, then its evaluation); for FCOS also a `--resume` from the
    step-1 checkpoint with model_final removed."""
    config = str(ROOT / "playground" / SYNTH.format(name) / "config.yaml")
    argv = ["--config", config, "--device", "cpu", "task=train", *SMALL_SYNTH,
            "solver.lr_scheduler.max_iters=2", "trainer.checkpoint_period=1",
            "trainer.log_interval=1"]
    out = base / "EFG_torch" / SYNTH.format(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EFG_CACHE_DIR", str(base))
        results = _capture_evaluations(mp)
        assert cli.main(argv) == 0
        run = dict(results=results, records=_records(out),
                   ckpts=sorted(f for f in os.listdir(out) if f.startswith("model_")),
                   final=torch.load(out / "model_final", weights_only=True))
        if name == "fcos":
            (out / "model_final").unlink()
            assert cli.main(["--resume", *argv, "trainer.evaluators="]) == 0
            run["resumed"] = torch.load(out / "model_final", weights_only=True)
            run["again"] = _records(out)[len(run["records"]):]
    return run


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            torch.set_num_threads(1)
            made[name] = _synthetic_run(tmp_path_factory.mktemp(f"synth_{name}"), name)
        return made[name]

    return get


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
def test_synthetic_train_records(synthetic, name):
    records = synthetic(name)["records"]
    assert [r["iteration"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records)


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
def test_synthetic_evaluates_with_coco_evaluator(synthetic, name):
    (res,) = synthetic(name)["results"]
    _check_coco_results(res)


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
def test_synthetic_checkpoints(synthetic, name):
    run = synthetic(name)
    assert run["ckpts"] == ["model_0000000", "model_final"], run["ckpts"]
    assert run["final"]["step"] == 2 and set(run["final"]["optimizer"]) == {"count", "trace"}


def test_synthetic_resume_is_bit_exact(synthetic):
    """FCOS resumed from its step-1 checkpoint ends where the
    uninterrupted run did: module, SGD trace, step, the iteration-2
    record."""
    run = synthetic("fcos")
    full, resumed = run["final"], run["resumed"]
    assert resumed["step"] == 2 and resumed["optimizer"]["count"] == 2
    for n, v in full["model"].items():
        assert torch.equal(resumed["model"][n], v), n
    for n, v in full["optimizer"]["trace"].items():
        assert torch.equal(resumed["optimizer"]["trace"][n], v), n
    assert [r["iteration"] for r in run["again"]] == [2]
    assert {k: v for k, v in run["again"][0].items() if k != "time"} == \
        {k: v for k, v in run["records"][1].items() if k != "time"}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Each COCO experiment through the CLI on the fixture, made when a test
    first asks for it: task=train (one iteration from the seeded
    torchvision R-50), and for FCOS task=val."""
    from test_torch_det2d_data import TRAIN_SIZES, VAL_SIZES, write_coco
    from test_torch_det2d_models import torchvision_resnet50_state_dict

    root = tmp_path_factory.mktemp("coco_cli")
    write_coco(root, "train", TRAIN_SIZES, 1)
    write_coco(root, "val", VAL_SIZES, 2)
    weights = root / "R-50.pth"
    torch.save(torchvision_resnet50_state_dict(5), weights)
    small = [f"detection.source.local.root={root}", f"model.weights={weights}",
             "solver.lr_scheduler.max_iters=1", "trainer.evaluators=", "dataloader.num_workers=1"]
    for split, i in (("train", 3), ("val", 2)):
        small += [f"dataset.processors.{split}[{i}].PadImage.height=96",
                  f"dataset.processors.{split}[{i}].PadImage.width=128",
                  f"dataset.processors.{split}[0].ResizeShortestEdge.max_size=128"]
    small += ["dataset.processors.train[0].ResizeShortestEdge.short_edge_length=[64,96]",
              "dataset.processors.val[0].ResizeShortestEdge.short_edge_length=96"]
    made = {}

    def get(name):
        if name in made:
            return made[name]
        torch.set_num_threads(1)
        base = tmp_path_factory.mktemp(f"coco_{name}")
        argv = ["--config", str(ROOT / "playground" / COCO[name] / "config.yaml"),
                "--device", "cpu", *small]
        out = base / "EFG_torch" / COCO[name]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("EFG_CACHE_DIR", str(base))
            mp.setenv("EFG_PATH", str(ROOT))
            results = _capture_evaluations(mp)
            assert cli.main([*argv, "task=train"]) == 0
            run = dict(log=(out / "log.txt.rank0").read_text(), records=_records(out))
            if name == "fcos":  # the synthetic tests evaluate every model; here one will do
                assert cli.main([*argv, "task=val", "trainer.evaluators=[COCOEvaluator]"]) == 0
                run.update(results=results, val_log=(out / "log.txt.rank0").read_text())
        made[name] = run
        return run

    return get


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
def test_coco_imports_the_torchvision_backbone(coco, name):
    """Every R-50 tensor but fc's lands; the 53 num_batches_tracked are
    skipped."""
    log = coco(name)["log"]
    assert "Imported 265 tensors from" in log and "skipped 53: ['bn1.num_batches_tracked'" in log


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
def test_coco_trains(coco, name):
    records = coco(name)["records"]
    assert [r["iteration"] for r in records] == [1]
    assert all(np.isfinite(r["loss"]) for r in records)


def test_coco_val_through_coco_evaluator(coco):
    run = coco("fcos")
    (res,) = run["results"]
    _check_coco_results(res)
    assert "COCO eval over 4 images" in run["val_log"]


# ------------------------------------------------------- data parallelism

def _loss_rank(out_dir, cases, device):
    torch.set_num_threads(1)
    r = comm.get_rank()
    res = {}
    for name, (preds, batch, cfg) in cases.items():
        p = {k: torch.from_numpy(v[r:r + 1]).requires_grad_() if k not in ("mu", "sigma")
             else torch.from_numpy(v) for k, v in preds.items()}
        p["shapes"] = cfg["_shapes"]
        b = {k: torch.from_numpy(v[r:r + 1]) for k, v in batch.items()}
        losses = MODELS[name].compute_loss(p, b, model_cfg=cfg)
        losses["loss"].backward()
        res[name] = dict(losses={k: float(v.detach()) for k, v in losses.items()},
                         summed={k: float(v) for k, v in ddp.sum_metrics(losses).items()},
                         grads={k: v.grad.numpy() for k, v in p.items()
                                if isinstance(v, torch.Tensor) and v.grad is not None})
    comm.synchronize()
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


@pytest.fixture(scope="module")
def ddp_cases():
    from test_torch_det2d_ops import CFG, SHAPES, gt_2d, preds_2d

    boxes, cls, mask = gt_2d(2)
    batch = dict(gt_boxes2d=boxes, gt_classes2d=cls, gt_mask2d=mask)
    rs = np.random.RandomState(6)
    prior = dict(mu=rs.uniform(-0.5, 0.5, (5, 2)).astype(np.float32),
                 sigma=rs.uniform(0.6, 1.4, (5, 2)).astype(np.float32))
    return {"fcos": (preds_2d(1), batch, dict(CFG, _shapes=SHAPES)),
            "retinanet": (preds_2d(2, retina=True), batch, dict(CFG, _shapes=SHAPES)),
            "autoassign": ({**preds_2d(3), **prior}, batch, dict(CFG, _shapes=SHAPES))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ddp_cases):
    out = tmp_path_factory.mktemp("ddp2d")
    init = f"tcp://127.0.0.1:{launch.free_port()}"
    specs = [launch.RankSpec(r, WORLD, r, WORLD, "gloo", init, "cpu") for r in range(WORLD)]
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rc = launch.spawn(_loss_rank, specs, (str(out), ddp_cases))
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    assert rc == 0
    got = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


def _one_process(ddp_cases, name):
    preds, batch, cfg = ddp_cases[name]
    p = {k: torch.from_numpy(v).requires_grad_() if k not in ("mu", "sigma") else torch.from_numpy(v)
         for k, v in preds.items()}
    p["shapes"] = cfg["_shapes"]
    want = MODELS[name].compute_loss(p, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     model_cfg=cfg)
    want["loss"].backward()
    return {k: float(v.detach()) for k, v in want.items()}, p


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
@pytest.mark.parametrize("reading", ["summed", "rank0", "rank1"])
def test_2d_loss_normalisers_are_global(ranks, ddp_cases, name, reading):
    """The ranks' losses, each on its sample over the global normalisers,
    add up to one process's loss on both samples (`summed`), and so does
    `ddp.sum_metrics` on every rank (`num_foreground` included)."""
    want, _ = _one_process(ddp_cases, name)
    g0, g1 = ranks[0][name], ranks[1][name]
    for k, w in want.items():
        got = {"summed": g0["losses"][k] + g1["losses"][k], "rank0": g0["summed"][k],
               "rank1": g1["summed"][k]}[reading]
        assert abs(got - w) <= DDP_TOL * max(abs(w), 1.0), (k, got, w)


@pytest.mark.parametrize("name", ["fcos", "retinanet", "autoassign"])
def test_2d_loss_gradients_are_global(ranks, ddp_cases, name):
    """The predictions' gradients of the ranks, stacked, are one
    process's."""
    _, p = _one_process(ddp_cases, name)
    g0, g1 = ranks[0][name], ranks[1][name]
    for k, v in p.items():
        if isinstance(v, torch.Tensor) and v.grad is not None:
            stacked = np.concatenate([g0["grads"][k], g1["grads"][k]])
            scale = max(float(v.grad.abs().max()), 1e-12)
            assert float(np.abs(stacked - v.grad.numpy()).max()) <= DDP_TOL * scale, k
