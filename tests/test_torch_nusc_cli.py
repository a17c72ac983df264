"""The nuScenes CenterPoint experiments through the port's CLI on the CPU,
on nuScenes-format fixture files prepared by the port's `create_data`
(`tests/test_torch_nuscenes_data.py`): `centerpoint.pillar.nusc_mini.1sweep`
and `centerpoint.nusc.voxelnet.cbgs.20e` (10 sweeps, CBGS, DatabaseSampling
first) shrunk by dotlist, 2 iterations of `task=train`, then `task=val`
from the checkpoint through nuScenesDetEvaluator; and `predict` of the
VoxelNet config's 6-task head with velocity at its own width (180×180
maps) against efg_tpu's."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.models import centerpoint as JCP
from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.engine import trainer as T
from efg_tpu_torch.models import centerpoint as TCP

from test_torch_nuscenes_data import PILLAR_EXP, VOXEL_EXP, nusc_config_file, prepare_nuscenes

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

PC = "[-12.0,-12.0,-5.0,12.0,12.0,3.0]"
SMALL = {
    PILLAR_EXP: [f"dataset.pc_range={PC}", "dataset.processors.train[5].PadPoints.num_points=2048",
                 "dataset.processors.val[1].PadPoints.num_points=2048", "model.max_pillars=4096",
                 "model.neck.layer_nums=[1,1,1]", "model.neck.ds_num_filters=[16,32,32]",
                 "model.neck.us_num_filters=[16,16,16]"],
    VOXEL_EXP: [f"dataset.pc_range={PC}", "dataset.processors.train[6].PadPoints.num_points=2048",
                "dataset.processors.val[1].PadPoints.num_points=2048", "model.max_voxels=2048",
                "model.stage_caps=[2048,2048,1024,1024]", "dataloader.batch_size=2",
                "dataloader.num_workers=0", "model.neck.layer_nums=[1,1]",
                "model.neck.ds_num_filters=[32,64]", "model.neck.us_num_filters=[32,32]"],
}
COMMON = ["model.post_process.nms.nms_pre_max_size=64", "trainer.log_interval=1",
          "trainer.window_size=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    base = tmp_path_factory.mktemp("nusc_cli")
    root = str(base / "nuscenes")
    prepare_nuscenes(root, n_points=1500)
    return {exp: nusc_config_file(str(base / "exp"), root, exp) for exp in (PILLAR_EXP, VOXEL_EXP)}


@pytest.mark.parametrize("exp", [PILLAR_EXP, VOXEL_EXP])
def test_cli_train_then_val(configs, exp, tmp_path, monkeypatch):
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    config, opts = configs[exp], [*SMALL[exp], *COMMON]
    evaluations = []
    evaluate = T.DefaultTrainer.evaluate

    def probe(trainer, evaluators=None):
        evaluations.append(evaluate(trainer, evaluators))
        return evaluations[-1]

    monkeypatch.setattr(T.DefaultTrainer, "evaluate", probe)
    assert cli.main(["--config", config, "--device", "cpu", "task=train", "trainer.evaluators=",
                     "solver.lr_scheduler.max_iters=2", *opts]) == 0
    out = tmp_path / "EFG_torch" / cli.experiment_relpath(config)
    recs = [json.loads(line) for line in open(out / "metrics.json")]
    losses = [r for r in recs if "loss" in r]
    assert [r["iteration"] for r in losses] == [1, 2]
    assert np.isfinite([r[k] for r in losses for k in r if "loss" in k]).all()
    assert sum(r[f"{t}_num_positive"] for r in losses for t in range(6)) > 0
    assert "model_final" in os.listdir(out)
    assert cli.main(["--config", config, "--device", "cpu", "task=val", *opts]) == 0
    (res,) = evaluations
    assert len(res) == 10 + 7 and np.isfinite(res["nusc/NDS"])
    assert all(np.isfinite(v) for k, v in res.items() if k != "nusc/mAP" and "/AP" not in k)


def test_voxelnet_predict_at_config_width_matches_jax(configs):
    """The VoxelNet config's post-processing (6 tasks, 10 classes, vel,
    NMS post 83 at IoU 0.2) decoding seeded 180×180 head maps (the config's
    1440-cell grid at out_size_factor 8): keep sets and labels exact,
    boxes to 1e-5. NMS takes 256 candidates a task, not the config's
    1000: the port's rotated IoU matrix on the CPU takes about 6 s for
    1000² pairs, and the card runs the config's own (chip_smoke phase
    nusc)."""
    opts = ["task=val", "model.post_process.nms.nms_pre_max_size=256"]
    jc = JConfiguration(config_file=configs[VOXEL_EXP], opts=opts).get_config()
    tc = Configuration(config_file=configs[VOXEL_EXP], opts=opts).get_config()
    cfg = TCP._model_cfg(tc)
    post = dict(tc.model.post_process)
    assert post == dict(jc.model.post_process) and post["nms"]["nms_post_max_size"] == 83
    rs = np.random.RandomState(0)
    maps = [{k: rs.randn(1, 180, 180, n).astype(np.float32) * (3.0 if k == "hm" else 1.0)
             - (2.5 if k == "hm" else 0.0)
             for k, n in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2),
                          ("hm", t["num_classes"]))} for t in cfg["tasks"]]
    want = jax.jit(lambda m: JCP.predict(m, post_cfg=post, model_cfg=cfg))(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in maps])
    got = TCP.predict([{k: torch.from_numpy(v) for k, v in t.items()} for t in maps],
                      post_cfg=post, model_cfg=cfg)
    assert got["box3d"].shape == (1, 6 * 83, 9)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["box3d"].numpy(), np.asarray(want["box3d"]), rtol=1e-5,
                               atol=1e-5)
    assert set(got["labels"].numpy()[got["valid"].numpy()].tolist()) == set(range(1, 11))
