"""The Waymo DETR experiments through the port's CLI on the CPU, on
Waymo-format fixture files (tests/test_torch_waymo_data.py's): both
configs at the tiny widths of tests/test_torch_waymo_detr.py, `task=train`
with DatabaseSampling first, then `task=val` from the checkpoint; the
ConQueR config takes its sibling's config.yaml by its relative `includes`
and fades its GT sampling."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.engine import trainer as T

from test_torch_waymo_data import prepare_waymo
from test_torch_waymo_detr import CONQUER, SHRINK, VOXELDETR, detr_config_files

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

CLI_SMALL = [*SHRINK, "dataset.processors.train[6].PadPoints.num_points=2048",
             "dataset.processors.val[1].PadPoints.num_points=2048", "dataloader.batch_size=2",
             "dataloader.num_workers=0", "trainer.log_interval=1", "trainer.window_size=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    base = tmp_path_factory.mktemp("waymo_detr_cli")
    root = str(base / "waymo")
    prepare_waymo(root)
    return detr_config_files(str(base / "exp"), root)


@pytest.mark.parametrize("exp", [VOXELDETR, CONQUER])
def test_cli_train_then_val(experiments, exp, tmp_path, monkeypatch):
    """task=train, 2 iterations at the tiny widths with DatabaseSampling
    first (ConQueR: denoising, the momentum decoder and the contrast loss;
    its `trainer.fade` drops the sampling at iteration 1), then task=val
    from the checkpoint through WaymoDetEvaluator on every other val frame:
    finite losses and waymo/* results."""
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    config = experiments[exp]
    evaluations = []
    evaluate = T.DefaultTrainer.evaluate

    def probe(trainer, evaluators=None):
        evaluations.append(evaluate(trainer, evaluators))
        return evaluations[-1]

    monkeypatch.setattr(T.DefaultTrainer, "evaluate", probe)
    assert cli.main(["--config", config, "--device", "cpu", "task=train", "trainer.evaluators=",
                     "solver.lr_scheduler.max_iters=2", *CLI_SMALL]) == 0
    out = tmp_path / "EFG_torch" / cli.experiment_relpath(config)
    recs = [json.loads(line) for line in open(out / "metrics.json")]
    losses = [r for r in recs if "loss" in r]
    assert [r["iteration"] for r in losses] == [1, 2]
    assert np.isfinite([r[k] for r in losses for k in r if k.startswith("loss")]).all()
    log = (out / "log.txt.rank0").read_text()
    assert ("Aug fade at iter 1" in log) == (exp == CONQUER)
    if exp == CONQUER:
        assert any("loss_contrastive_dec_0" in r for r in losses)
    assert cli.main(["--config", config, "--device", "cpu", "task=val", "dataset.load_interval=2",
                     *CLI_SMALL]) == 0
    (res,) = evaluations
    assert len(res) == 13 and np.isfinite(list(res.values())).all()
    assert "model_final" in os.listdir(out)
