"""Port parity of evaluation as a whole: efg_tpu's `DefaultTrainer.evaluate`
and the port's run the synthetic experiment's val split at a small size
from the same weights (efg_tpu's initial state, mapped through the weight
mapper), each with its own loader (the loaders agree bit for bit,
tests/test_torch_data.py) and its own `WaymoDetEvaluator`.

efg_tpu runs in a subprocess on one CPU device; both compute every conv in
f32, as tests/test_torch_trainer_parity.py does, and every stage cap stays above
occupancy (efg_tpu's XLA rule9 misreads a tap at full capacity).

The per-frame predictions are held as follows. The CenterHead's heatmap
bias starts at −2.19, so with random weights the scores sit around
sigmoid(−2.19) ≈ 0.1, the config's `score_threshold`. A box whose score
lies within SCORE_BAND = 1e-4 of the threshold in either package may pass
the filter in one and not in the other; such boxes rank last (NMS keeps
boxes by descending score, and a box can only suppress lower-scored ones),
so each frame is compared on its leading boxes scored above threshold +
SCORE_BAND in both packages: valid masks equal there, boxes and scores
within 1e-4 relative (boxes: 1e-4 of the frame's largest |coordinate|
where a coordinate is near 0). The boxes in the band are counted and must
all rank after the compared ones.

Separately, efg_tpu's own predictions go through both packages'
evaluators, whose results must be equal (to 1e-9, NaN for NaN). efg_tpu's
evaluator takes its IoU matrix from its `iou_3d` under jit on padded boxes,
as tests/test_torch_evaluator.py does (eagerly, 7 s a shape)."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import efg_tpu_torch.data  # noqa: F401  (registrations)
from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.engine.trainer import DefaultTrainer
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator
from efg_tpu_torch.evaluator.waymo_evaluator import WaymoDetEvaluator
from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

from test_torch_evaluator import assert_results_equal
from test_torch_train import _record_occupancy

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml")
# tests/test_torch_trainer_parity.py's small size (12.8 m square, 2048
# points, stage caps above occupancy), the val split cut to 4 frames
OPTS = ["dataset.points_per_frame=2048", "dataset.processors.train[5].PadPoints.num_points=2048",
        "dataset.processors.val[1].PadPoints.num_points=2048", "dataset.num_frames=4",
        "model.max_voxels=2048", "model.stage_caps=[5120,3072,640,512]",
        "dataset.pc_range=[-6.4,-6.4,-2.0,6.4,6.4,4.0]", "model.neck.layer_nums=[1,1]",
        "model.neck.ds_num_filters=[32,64]", "model.neck.us_num_filters=[32,32]"]
EVAL_SEED = 3  # numpy's global RNG before evaluate(), the same in both processes
SCORE_BAND = 1e-4
RTOL = 1e-4

# efg_tpu's side: its DefaultTrainer on one CPU device with every conv in
# f32 (test_torch_trainer_parity's JAX_SIDE); dumps its initial variables,
# then evaluates with a recorder of every batch beside WaymoDetEvaluator
JAX_SIDE = r"""
import importlib.util, pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
import efg_tpu.data  # registrations
from efg_tpu.config import Configuration
from efg_tpu.engine.trainer import DefaultTrainer
from efg_tpu.evaluator import det3d_metrics as JD, waymo_official as JWO
from efg_tpu.evaluator.evaluator import DatasetEvaluator
from efg_tpu.evaluator.waymo_evaluator import WaymoDetEvaluator
from efg_tpu.modeling.backbones import rpn as JRPN
from efg_tpu.ops.iou_rotated import iou_3d
from efg_tpu.modeling.heads import center_head as JCH
from efg_tpu.ops import sparse as S
from efg_tpu.utils.seed import seed_all_rng

class F32Jnp:
    bfloat16 = jnp.float32
    def __getattr__(self, name):
        return getattr(jnp, name)

class JitInit:
    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init, static_argnames="train")
    def __getattr__(self, name):
        return getattr(self._module, name)

class Recorder(DatasetEvaluator):
    def __init__(self):
        self.batches = []
    def process(self, inputs, outputs):
        self.batches.append((inputs["annotations"], {k: np.asarray(v) for k, v in outputs.items()}))

JIT_IOU = jax.jit(iou_3d)

def pad(boxes, rows=16):  # tests/test_torch_evaluator.py's _pad
    n = len(boxes)
    far = np.zeros((-(-max(n, 1) // rows) * rows - n, 7), np.float32)
    far[:, 0] = 1e3 + 10.0 * np.arange(len(far))
    far[:, 3:6] = 1.0
    return np.concatenate([np.asarray(boxes, np.float32)[:, :7], far])

def bev_iou_matrix(pred, gt):
    if pred.shape[0] == 0 or gt.shape[0] == 0:
        return np.zeros((pred.shape[0], gt.shape[0]), np.float32)
    return np.asarray(JIT_IOU(pad(pred), pad(gt)))[:len(pred), :len(gt)]

JD._bev_iou_matrix = JWO._bev_iou_matrix = bev_iou_matrix
S.COMPUTE_DTYPE = jnp.float32
JRPN.jnp = JCH.jnp = F32Jnp()
config_path, out_dir, eval_seed, opts = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4:]
cfg = Configuration(config_file=config_path, opts=opts).get_config()
cfg["trainer"]["output_dir"] = out_dir
seed_all_rng(cfg.misc.seed)
spec = importlib.util.spec_from_file_location("net", config_path.rsplit("/", 1)[0] + "/net.py")
net = importlib.util.module_from_spec(spec)
spec.loader.exec_module(net)

def build(config):
    md = net.build_model(config)
    md.module = JitInit(md.module)
    return md

trainer = DefaultTrainer(cfg, build)
rec = Recorder()
np.random.seed(eval_seed)
results = trainer.evaluate([rec, WaymoDetEvaluator(cfg, None)])
with open(out_dir + "/eval.pkl", "wb") as f:
    pickle.dump({"variables": jax.device_get({"params": trainer.state.params,
                                              "batch_stats": trainer.state.batch_stats}),
                 "batches": rec.batches, "results": results,
                 "mesh": dict(trainer.mesh.shape)}, f)
"""


class Recorder(DatasetEvaluator):
    def __init__(self):
        self.batches = []

    def process(self, inputs, outputs):
        self.batches.append((inputs["annotations"], outputs))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test runner runs several files at once on
    the same cores (tests/test_torch_trainer_parity.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_evaluate(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1 --xla_cpu_multi_thread_eigen=false")
    out = subprocess.run([sys.executable, "-c", JAX_SIDE, CONFIG, str(out_dir), str(EVAL_SEED),
                          *OPTS], cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(out_dir / "eval.pkl", "rb") as f:
        return pickle.load(f)


def _compare_frame(got, want, thr):
    """(compared boxes, boxes in the band) of one frame; see the module
    docstring."""
    ranked = [(o["valid"] & (o["scores"] > thr + SCORE_BAND)) for o in (got, want)]
    band = [o["valid"] & (np.abs(o["scores"] - thr) <= SCORE_BAND) for o in (got, want)]
    np.testing.assert_array_equal(ranked[0], ranked[1])
    n = int(ranked[1].sum())
    assert ranked[1][:n].all(), "boxes above the band must lead"
    for b in band:
        assert not b[:n].any(), "a box in the band ranks before a compared box"
    if n:
        np.testing.assert_array_equal(got["labels"][:n], want["labels"][:n])
        np.testing.assert_allclose(got["scores"][:n], want["scores"][:n], rtol=RTOL, atol=0)
        scale = float(np.abs(want["box3d"][:n]).max())
        np.testing.assert_allclose(got["box3d"][:n], want["box3d"][:n], rtol=RTOL,
                                   atol=RTOL * scale)
    return n, int(max(b.sum() for b in band))


def test_port_evaluate_matches_efg_tpu_evaluate(tmp_path, monkeypatch):
    monkeypatch.setattr(K, "COMPUTE_DTYPE", torch.float32)
    ref = _jax_evaluate(tmp_path / "jax")
    assert ref["mesh"] == {"data": 1, "model": 1}

    tnet = cli.load_experiment_module(CONFIG)

    def build_f32(config, device, generator):
        md = tnet.build_model(config, device=device, generator=generator)
        for m in md.module.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                m.dtype = None
        return md

    cfg = Configuration(config_file=CONFIG, opts=list(OPTS)).get_config()
    cfg["trainer"]["output_dir"] = str(tmp_path / "torch")
    trainer = DefaultTrainer(cfg, build_f32, device="cpu")
    module = trainer.state.module
    module.load_state_dict(flax_to_state_dict(module, ref["variables"]))
    occupancy = _record_occupancy(module)
    rec = Recorder()
    np.random.seed(EVAL_SEED)
    results = trainer.evaluate([rec, WaymoDetEvaluator(cfg, None)])

    # the same frames in the same order
    assert len(rec.batches) == len(ref["batches"]) == 2
    thr = float(cfg.model.post_process.score_threshold)
    compared, in_band = 0, 0
    for (annos, out), (ref_annos, ref_out) in zip(rec.batches, ref["batches"]):
        assert set(out) == set(ref_out) == {"box3d", "scores", "labels", "valid"}
        for a, r in zip(annos, ref_annos):
            np.testing.assert_array_equal(a["gt_boxes"], r["gt_boxes"])
        for b in range(len(annos)):
            n, k = _compare_frame({k: v[b] for k, v in out.items()},
                                  {k: v[b] for k, v in ref_out.items()}, thr)
            compared, in_band = compared + n, in_band + k
    assert compared >= 30, compared  # the comparison holds many boxes
    assert in_band <= compared // 10, (in_band, compared)
    assert len(occupancy) == 5 * 2
    assert all(n < cap for _, n, cap in occupancy), occupancy
    assert not any(K.launches.values())

    # the results: the same key set; equal when no box lies in the band
    assert set(results) == set(ref["results"])
    assert all(k.startswith("waymo/") for k in results)
    if in_band == 0:
        assert_results_equal(results, ref["results"])

    # efg_tpu's predictions through the port's evaluator
    ev = WaymoDetEvaluator(cfg, None)
    ev.reset()
    for annos, ref_out in ref["batches"]:
        ev.process({"annotations": annos}, ref_out)
    assert_results_equal(ev.evaluate(), ref["results"])
