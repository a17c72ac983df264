"""The port's CLI on the synthetic ConQueR experiment
(`playground/detection.3d/synthetic/conquer.synth.res18`), on the CPU:
`task=val` builds the model from the experiment's config through the
port's net.py, evaluates the val split with the config's
WaymoDetEvaluator and logs finite `waymo/*` results; `task=train` is not
ported (ROADMAP queue 1 item 8) and says so before any set-up."""

import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.engine import trainer as T

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
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match=r"not ported.*ROADMAP queue 1 item 8"):
        cli.main(["--config", CONFIG, "--device", "cpu", "task=train", *SMALL])
    assert not any(f.startswith("model_") for f in os.listdir(
        tmp_path / "EFG_torch" / "detection.3d/synthetic/conquer.synth.res18"))
