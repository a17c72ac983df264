"""The panoptic experiments through the port's CLI on the CPU, and the
training step's randomness.

- `panoptic_seg/synthetic/mask2former.synth.res50` as written but for
  64×64 images, 4 frames and 4 iterations: `task=train` (the loss gets the step's
  generator), a `--resume` from the step-2 checkpoint that reads the
  uninterrupted run's losses of steps 3 and 4 bit for bit (the same
  points drawn), then `task=val`.
- The two COCO panoptic configs on the COCO-panoptic fixture of
  `test_torch_panoptic_data` (canvas and LSJ target cut by dotlist, 512
  points), with the two overrides their efg_tpu failures force
  (`solver.lr_scheduler.milestones`, `trainer.evaluators=[PanopticEvaluator]`):
  R-50 from a seeded torchvision `.pth` (format `resnet`), Swin-T from a
  seeded mmdet-format Swin-T `.pth` (`model.weights_format: swin`, every
  tensor of the trunk imported); 1 iteration, then the evaluation after
  training through `PanopticEvaluator`.
- `step_generator`: the same (seed, step) draws the same, the loss stream
  apart from the model's; `train_step` hands a loss that declares `rng`
  the step's loss stream and a forward that declares `generator` the
  model's.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.engine import trainer as T
from efg_tpu_torch.engine.train_state import ModelDef

from test_torch_panoptic_data import VAL_SIZES, small_opts, write_coco_panoptic
from test_torch_swin import mmdet_swin

ROOT = Path(__file__).resolve().parents[1]
SYNTH = "panoptic_seg/synthetic/mask2former.synth.res50"
COCO = "panoptic_seg/coco/mask2former/mask2former.pano_coco.{}.bs16.50e"
SMALL_SYNTH = ["dataset.image_size=64", "dataset.num_frames=4",
               *[f"dataset.processors.{s}[{i}].{p}.{d}=64" for s in ("train", "val")
                 for i, p in ((1, "RasterizeMasks"), (2, "PadImage")) for d in ("height", "width")]]
SWIN_T = dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7,
              pretrain_img_size=224)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(out):
    return [r for r in (json.loads(line) for line in open(out / "metrics.json")) if "loss" in r]


def _capture_evaluations(mp):
    results = []
    evaluate = T.DefaultTrainer.evaluate

    def wrapped(self, evaluators=None):
        results.append(evaluate(self, evaluators))
        return results[-1]

    mp.setattr(T.DefaultTrainer, "evaluate", wrapped)
    return results


def test_synthetic_train_resume_val(tmp_path, monkeypatch):
    config = str(ROOT / "playground" / SYNTH / "config.yaml")
    out = tmp_path / "EFG_torch" / SYNTH
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    argv = ["--config", config, "--device", "cpu", "task=train", *SMALL_SYNTH,
            "solver.lr_scheduler.max_iters=4", "trainer.checkpoint_period=2",
            "trainer.log_interval=1", "trainer.window_size=1"]
    assert cli.main(argv) == 0
    first = _records(out)
    assert [r["iteration"] for r in first] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and "loss_dice_0" in r for r in first)
    ckpts = sorted(f for f in os.listdir(out) if f.startswith("model_"))
    assert "model_0000001" in ckpts  # after step 2 (efg_tpu names it by the 0-based iteration)
    for f in ckpts:
        if f not in ("model_0000001",):
            (out / f).unlink()
    assert cli.main(["--resume", *argv]) == 0
    again = _records(out)[len(first):]
    assert [r["iteration"] for r in again] == [3, 4]
    for a, b in zip(again, first[2:]):
        assert {k: v for k, v in a.items() if k.startswith("loss")} == \
            {k: v for k, v in b.items() if k.startswith("loss")}
    results = _capture_evaluations(monkeypatch)
    assert cli.main(["--config", config, "--device", "cpu", "task=val", *SMALL_SYNTH]) == 0
    assert results == [{}]  # the experiment names no evaluator


def test_step_generator_streams():
    """Every input reaches the draws, on the CPU too, whose mt19937 reads
    only a seed's low 32 bits (`(seed << 32) | step` left the seed out)."""
    def draw(seed, step, stream=0):
        return torch.rand(8, generator=T.step_generator(seed, step, "cpu", stream))

    a = draw(21, 5)
    assert torch.equal(a, draw(21, 5))
    for other in (draw(21, 5, 1), draw(21, 6), draw(22, 5), draw(21 + 2 ** 31, 5, 1)):
        assert not torch.equal(a, other)
    assert torch.equal(torch.rand(3, generator=torch.Generator().manual_seed(1 << 32)),
                       torch.rand(3, generator=torch.Generator().manual_seed(0)))


def test_train_step_hands_out_the_streams():
    seen = {}

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))

        def forward(self, x, generator=None):
            seen["forward"] = torch.rand(4, generator=generator)
            return dict(y=x * self.w)

    def loss_fn(preds, batch, rng=None):
        seen["loss"] = torch.rand(4, generator=rng)
        return dict(loss=preds["y"].sum())

    class Tx:
        def step(self, params, grads, opt_state, grad_norm):
            pass

    md = ModelDef(Net(), lambda batch: dict(x=batch["x"]), loss_fn)
    state = T.TrainState(step=7, module=md.module, opt_state=None)
    T.train_step(md, Tx(), state, dict(x=torch.ones(3)), seed=3)
    assert torch.equal(seen["forward"], torch.rand(4, generator=T.step_generator(3, 7, "cpu")))
    assert torch.equal(seen["loss"], torch.rand(4, generator=T.step_generator(3, 7, "cpu", 1)))
    assert state.step == 8


@pytest.fixture(scope="module")
def coco_panoptic(tmp_path_factory):
    """The fixture's root and the two seeded backbone files."""
    from test_torch_det2d_models import torchvision_resnet50_state_dict

    base = tmp_path_factory.mktemp("coco_panoptic_cli")
    write_coco_panoptic(base / "coco", "train", [(48, 64), (64, 48), (40, 60)], 1)
    write_coco_panoptic(base / "coco", "val", VAL_SIZES, 2)
    torch.save(torchvision_resnet50_state_dict(3), base / "R-50.pth")
    torch.save({k: torch.from_numpy(v) for k, v in mmdet_swin(4, SWIN_T).items()},
               base / "swin_tiny.pth")
    return base


@pytest.mark.parametrize("name", ["res50", "swin_t"])
def test_coco_panoptic_configs_train_and_evaluate(coco_panoptic, name, tmp_path, monkeypatch):
    base = coco_panoptic
    config = str(ROOT / "playground" / COCO.format(name) / "config.yaml")
    weights = base / ("R-50.pth" if name == "res50" else "swin_tiny.pth")
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("EFG_PATH", str(ROOT))
    results = _capture_evaluations(monkeypatch)
    imports = []
    from efg_tpu_torch.utils import torch_import as TTI

    fn = "import_torchvision_resnet" if name == "res50" else "import_swin"
    imp = getattr(TTI, fn)
    monkeypatch.setattr(TTI, fn, lambda sd, module, prefix: imports.append(
        (imp(sd, module, prefix), len(sd), module)) or imports[-1][0])
    argv = ["--config", config, "--device", "cpu", "task=train",
            *small_opts(base / "coco", canvas=(64, 96), lsj=96),
            "solver.lr_scheduler.milestones=[1]", "solver.lr_scheduler.max_iters=1",
            "trainer.evaluators=[PanopticEvaluator]", f"model.weights={weights}",
            "model.mask2former.num_points=512", "trainer.log_interval=1"]
    assert cli.main(argv) == 0
    out = tmp_path / "EFG_torch" / COCO.format(name)
    recs = _records(out)
    assert [r["iteration"] for r in recs][-1] == 1 and all(np.isfinite(r["loss"]) for r in recs)
    ((res,),) = [results]
    assert set(res) == {"panoptic/PQ", "panoptic/SQ", "panoptic/RQ", "panoptic/n_categories"}
    assert all(0.0 <= res[f"panoptic/{k}"] <= 1.0 for k in ("PQ", "SQ", "RQ"))
    ((n, skipped), n_file, module), = imports
    backbone = module.backbone.state_dict()
    if name == "res50":  # every tensor of the trunk; num_batches_tracked has no place
        assert n == len(backbone) and len(skipped) == 53
        assert all(k.endswith("num_batches_tracked") for k in skipped)
    else:  # and its dropped buffers; the classifier and the APE (ape: False) have no place
        assert sorted(skipped) == ["absolute_pos_embed", "head.weight"]
        assert n - sum(k.endswith(("relative_position_index", "attn_mask"))
                       for k in mmdet_swin(4, SWIN_T)) == len(backbone)
        assert n_file == len(skipped) + n
