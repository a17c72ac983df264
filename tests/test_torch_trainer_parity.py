"""Port parity of the slice as a whole: efg_tpu's DefaultTrainer and the
port's train the synthetic experiment for 3 iterations at a small size,
from the same initial weights (the JAX trainer's state before train(),
mapped through the weight mapper) on the same batches (each trainer's own
loader; the loaders agree bit for bit, tests/test_torch_data.py).

efg_tpu runs in a subprocess on one CPU device at the experiment's bs=2,
so its batch statistics are those of the whole batch, as in one port
process. Its run is made once per test session (`jax_trainer_output`):
tests/test_torch_ddp_trainer.py holds two ranks to the same records, and
the test workers share the run's directory under a file lock. Both
compute every conv in f32, monkeypatched as
tests/test_torch_train.py does, and are held to that file's whole-model
tolerances (observed: step 1 ≤ 8.1e-7 and grad_norm 1.4e-6; step 2 ≤
8.4e-6 and 8.3e-4; step 3 ≤ 1.4e-3 and 1.1e-2). Every stage cap stays
above occupancy: efg_tpu's XLA rule9 misreads a tap at full capacity,
which moved step 1 by 1.9e-5 when down1 was full."""

import fcntl
import json
import os
import pickle
import shutil
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
from efg_tpu_torch.modeling.backbones.rpn import Conv2d, ConvTranspose2d
from efg_tpu_torch.ops.cuda import sparse_kernels as K
from efg_tpu_torch.utils.jax_import import flax_to_state_dict
from efg_tpu_torch.utils.seed import seed_all_rng

from test_torch_train import STEP_TOL, _record_occupancy

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml")
# the golden's small overrides, with a 12.8 m square, a narrower RPN, and
# per-sample stage caps above occupancy (at most about 4250 / 2260 / 420 /
# 320 voxels per sample after the four downsamples on these scenes)
OPTS = ["trainer.evaluators=", "dataset.points_per_frame=2048",
        "dataset.processors.train[5].PadPoints.num_points=2048", "model.max_voxels=2048",
        "model.stage_caps=[5120,3072,640,512]",
        "dataset.pc_range=[-6.4,-6.4,-2.0,6.4,6.4,4.0]", "model.neck.layer_nums=[1,1]",
        "model.neck.ds_num_filters=[32,64]", "model.neck.us_num_filters=[32,32]",
        "trainer.log_interval=1", "trainer.window_size=1",
        "trainer.checkpoint_period=1000000"]
ITERS = 3

# efg_tpu's side: its DefaultTrainer on one CPU device with every conv in
# f32; dumps the state before train() and trains the first ITERS
# iterations of the experiment's 30-iteration schedule. Its flax `init`
# runs under jax.jit (the same values as the eager init, one compile
# instead of one per primitive).
JAX_SIDE = r"""
import importlib.util, json, pickle, sys
import jax
import jax.numpy as jnp
import efg_tpu.data  # registrations
from efg_tpu.config import Configuration
from efg_tpu.engine.trainer import DefaultTrainer
from efg_tpu.modeling.backbones import rpn as JRPN
from efg_tpu.modeling.heads import center_head as JCH
from efg_tpu.ops import sparse as S
from efg_tpu.utils.seed import seed_all_rng

class F32Jnp:  # jax.numpy with bfloat16 read as float32 (test_torch_train's _F32Jnp)
    bfloat16 = jnp.float32
    def __getattr__(self, name):
        return getattr(jnp, name)

class JitInit:
    def __init__(self, module):
        self._module = module
        self.init = jax.jit(module.init, static_argnames="train")
    def __getattr__(self, name):
        return getattr(self._module, name)

S.COMPUTE_DTYPE = jnp.float32
JRPN.jnp = JCH.jnp = F32Jnp()
config_path, out_dir, iters, opts = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4:]
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
with open(out_dir + "/variables.pkl", "wb") as f:
    pickle.dump(jax.device_get({"params": trainer.state.params,
                                "batch_stats": trainer.state.batch_stats}), f)
max_iters = trainer.max_iters
trainer.max_iters = iters
trainer.train()
print(json.dumps({"mesh": dict(trainer.mesh.shape), "step": int(trainer.state.step),
                  "max_iters": max_iters}))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner runs several files at once on the same cores, where
    torch's OpenMP threads oversubscribe them (one 5 s test here took 830
    s): one intra-op thread keeps this file's cost its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_trainer(out_dir: Path, config_path=CONFIG, opts=OPTS, iters=ITERS) -> dict:
    out_dir.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1 --xla_cpu_multi_thread_eigen=false")
    out = subprocess.run([sys.executable, "-c", JAX_SIDE, config_path, str(out_dir), str(iters),
                          *opts], cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def jax_trainer_output(tmp_path_factory, config, name="efg_tpu_trainer_parity",
                       config_path=CONFIG, opts=OPTS, iters=ITERS) -> Path:
    """The directory of efg_tpu's run of the experiment `config_path`
    with `opts` for `iters` iterations of its own schedule
    (variables.pkl, metrics.json and its info.json), made under `name` by
    the first test of the session that asks for it: the test workers
    share the session's temp root, and a file lock makes a second asker
    wait for the first one's run instead of repeating it."""
    root = tmp_path_factory.getbasetemp()
    if hasattr(config, "workerinput"):  # a worker of the parallel runner
        root = root.parent
    out = root / name
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "info.json").exists():
            shutil.rmtree(out, ignore_errors=True)
            info = _jax_trainer(out, config_path, opts, iters)
            (out / "info.json").write_text(json.dumps(info))
    return out


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_port_trainer_matches_efg_tpu_trainer(tmp_path, tmp_path_factory, request,
                                              monkeypatch):
    monkeypatch.setattr(K, "COMPUTE_DTYPE", torch.float32)
    jax_dir = jax_trainer_output(tmp_path_factory, request.config)
    info = json.loads((jax_dir / "info.json").read_text())
    assert info == {"mesh": {"data": 1, "model": 1}, "step": ITERS, "max_iters": 30}
    with open(jax_dir / "variables.pkl", "rb") as f:
        variables = pickle.load(f)

    tnet = cli.load_experiment_module(CONFIG)

    def build_f32(config, device, generator):
        md = tnet.build_model(config, device=device, generator=generator)
        for m in md.module.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                m.dtype = None
        return md

    tcfg = Configuration(config_file=CONFIG, opts=list(OPTS)).get_config()
    tcfg["trainer"]["output_dir"] = str(tmp_path / "torch")
    seed_all_rng(tcfg.misc.seed)
    tt = DefaultTrainer(tcfg, build_f32, device="cpu")
    module = tt.state.module
    module.load_state_dict(flax_to_state_dict(module, variables))
    occupancy = _record_occupancy(module)

    # the first 3 iterations of the experiment's 30-iteration schedule
    assert tt.max_iters == 30
    tt.max_iters = ITERS
    tt.train()

    want = _records(jax_dir / "metrics.json")
    got = _records(tmp_path / "torch" / "metrics.json")
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] == list(range(ITERS + 1))
    assert set().union(*map(set, got)) == set().union(*map(set, want))
    for it in range(1, ITERS + 1):
        w, g = want[it], got[it]
        assert set(g) == set(w)
        for k in ("loss", "0_hm_loss", "0_loc_loss", "grad_norm"):
            rel = STEP_TOL["float32", it > 1][k == "grad_norm"]
            assert g[k] == pytest.approx(w[k], rel=rel), (it, k, g[k], w[k])
        assert g["0_num_positive"] == w["0_num_positive"] > 0
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert len(occupancy) == 5 * ITERS
    assert all(n < cap for _, n, cap in occupancy), occupancy
    assert tt.state.step == ITERS
    assert not any(K.launches.values())
    assert np.isfinite([r["loss"] for r in got[1:]]).all()
