"""The port's CLI on the synthetic ConQueR experiment
(`playground/detection.3d/synthetic/conquer.synth.res18`), on the CPU:
`task=val` builds the model from the experiment's config through the
port's net.py, evaluates the val split with the config's
WaymoDetEvaluator and logs finite `waymo/*` results; `task=train` trains
the experiment's model with its denoising queries, momentum decoder and
losses, checkpoints (the EMA state included) and resumes bit for bit."""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.engine import trainer as T

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.3d/synthetic/conquer.synth.res18/config.yaml")
# 4 val frames (2 batches of 2) of 2048 points; the model as the config
# writes it but for its point and voxel counts
SMALL = ["dataset.num_frames=4", "dataset.points_per_frame=2048",
         "dataset.processors.val[1].PadPoints.num_points=2048", "model.max_voxels=2048",
         "model.resnet_caps=[3072,2048,1024,512]"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_conquer_val_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    results = []
    evaluate = T.DefaultTrainer.evaluate

    def wrapped(self, evaluators=None):
        results.append(evaluate(self, evaluators))
        return results[-1]

    monkeypatch.setattr(T.DefaultTrainer, "evaluate", wrapped)
    assert cli.main(["--config", CONFIG, "--device", "cpu", "task=val", *SMALL]) == 0
    (res,) = results
    keys = [k for k in res if k.startswith("waymo/")]
    assert len(keys) == len(res) == 3 * 2 * 2 + 1  # 3 classes × L1/L2 × AP/APH, + mAPH
    assert all(np.isfinite(v) for v in res.values())
    out = tmp_path / "EFG_torch" / "detection.3d/synthetic/conquer.synth.res18"
    with open(out / "log.txt.rank0") as f:
        log = f.read()
    assert "Waymo eval over 4 frames" in log and "Evaluation results: {'waymo/" in log


def test_conquer_train_is_not_ported(tmp_path, monkeypatch):
    """task=train now runs (the name predates the port of ConQueR's
    training): two iterations with a checkpoint after the first; a
    `--resume` run from it, with model_final removed, ends bit for bit where the uninterrupted one did — module,
    AdamW state, step, the EMA decoder and the iteration-2 record (the step's
    denoising noise is drawn from a generator seeded by (seed, step))."""
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    # fade off: AugFadeHook restarts the data stream from the loader's
    # start_batch, in efg_tpu as in the port, so a run resumed on either side
    # of the fade reads other batches than an uninterrupted one (ROADMAP
    # queue 3, "the reference behaves in the ways below")
    opts = [*SMALL, "dataset.processors.train[2].PadPoints.num_points=2048",
            "trainer.evaluators=", "solver.lr_scheduler.max_iters=2", "trainer.checkpoint_iter=1",
            "trainer.log_interval=1", "trainer.fade=0"]
    argv = ["--config", CONFIG, "--device", "cpu", "task=train", *opts]
    assert cli.main(argv) == 0
    out = tmp_path / "EFG_torch" / "detection.3d/synthetic/conquer.synth.res18"
    ckpts = sorted(f for f in os.listdir(out) if f.startswith("model_"))
    assert ckpts == ["model_0000000", "model_final"], ckpts
    full = torch.load(out / "model_final", weights_only=True)
    lines = [json.loads(line) for line in open(out / "metrics.json")]
    records = [r for r in lines if "loss" in r]
    assert [r["iteration"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records) and "loss_contrastive_dec_1" in records[0]
    assert full["step"] == 2 and set(full["ema"]) == {
        n[len("detr.decoder."):] for n in full["model"] if n.startswith("detr.decoder.")}
    (out / "model_final").unlink()
    assert cli.main(["--resume", *argv]) == 0
    resumed = torch.load(out / "model_final", weights_only=True)
    assert resumed["step"] == 2
    for part in ("model", "ema"):
        assert set(resumed[part]) == set(full[part])
        for n, v in full[part].items():
            assert torch.equal(resumed[part][n], v), (part, n)
    for k in ("mu", "nu"):
        for n, v in full["optimizer"][k].items():
            assert torch.equal(resumed["optimizer"][k][n], v), (k, n)
    again = [r for r in (json.loads(line) for line in open(out / "metrics.json"))
             if "loss" in r][len(records):]
    assert [r["iteration"] for r in again] == [2]
    assert {k: v for k, v in again[0].items() if k != "time"} == \
        {k: v for k, v in records[1].items() if k != "time"}
