"""The port's entry point on the CPU: events and hooks, the trainer loop
against `train_step` driven by hand, cuDNN held to deterministic
algorithms in the loop, checkpoints, resume continuity bit
for bit, SIGTERM preemption, evaluation after training and `task=val`
from a checkpoint, `EvalHook` and `ProfilerHook`, the requests that are
not ported yet, and the initial weights' generator.

Runs the synthetic experiment with the golden's small overrides (2048
points, max_voxels 2048, small stage caps; no evaluators where a test
trains only), so the trunk runs at full width on few voxels."""

import json
import os
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import efg_tpu_torch.data  # noqa: F401  (registrations)
from efg_tpu.engine.hooks import EvalHook as JEvalHook
from efg_tpu.evaluator.waymo_evaluator import WaymoDetEvaluator as JWaymoDetEvaluator
from efg_tpu.utils.events import EventStorage as JEventStorage
from efg_tpu.utils.events import JSONWriter as JJSONWriter
from efg_tpu_torch.cli import main as cli
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data.builder import build_dataloader, build_dataset
from efg_tpu_torch.data.prefetcher import DevicePrefetcher
from efg_tpu_torch.engine import hooks as H
from efg_tpu_torch.engine import trainer as T
from efg_tpu_torch.engine.trainer import DefaultTrainer, init_state, train_step
from efg_tpu_torch.models.centerpoint import VoxelNet
from efg_tpu_torch.solver.optimizers import build_optimizer
from efg_tpu_torch.solver.schedulers import build_scheduler
from efg_tpu_torch.utils.events import EventStorage, JSONWriter
from efg_tpu_torch.utils.history_buffer import HistoryBuffer
from efg_tpu_torch.utils.seed import seed_all_rng

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXP = "playground/detection.3d/synthetic/centerpoint.synth.voxelnet"
CONFIG = str(ROOT / EXP / "config.yaml")
SMALL = ["trainer.evaluators=", "dataset.points_per_frame=2048",
         "dataset.processors.train[5].PadPoints.num_points=2048", "model.max_voxels=2048",
         "model.stage_caps=[1536,1024,768,768]", "trainer.log_interval=1",
         "trainer.window_size=1"]
# the experiment as written, evaluator included, at SMALL's size with a
# val split of 4 frames (2 batches)
EVAL_SMALL = [o for o in SMALL if not o.startswith("trainer.evaluators")] + [
    "dataset.processors.val[1].PadPoints.num_points=2048", "dataset.num_frames=4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test runner runs several files at once on the same cores, where
    torch's OpenMP threads oversubscribe them (one 5 s test here took 830
    s): one intra-op thread keeps this file's cost its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(out_dir, opts=()):
    cfg = Configuration(config_file=CONFIG, opts=SMALL + list(opts)).get_config()
    cfg["trainer"]["output_dir"] = str(out_dir)
    return cfg


def _trainer(out_dir, opts=(), device="cpu"):
    cfg = _config(out_dir, opts)
    seed_all_rng(cfg.misc.seed)
    return DefaultTrainer(cfg, cli.load_experiment_module(CONFIG).build_model, device=device)


def _records(path):
    """{iteration: record} of the records that carry a loss (the last one
    written wins)."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                out[int(rec["iteration"])] = rec
    return out


def _cli_env(cache):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), EFG_CACHE_DIR=str(cache), OMP_NUM_THREADS="1")
    return env


def _cli_cmd(*opts, resume=False):
    return [sys.executable, "-m", "efg_tpu_torch.cli.main", "--config", CONFIG,
            *(["--resume"] if resume else []), "--device", "cpu", "task=train", *SMALL,
            *opts]


def _out(cache):
    return Path(cache) / "EFG_torch" / "detection.3d/synthetic/centerpoint.synth.voxelnet"


# ------------------------------------------------------------------ events

def test_history_buffer_stats():
    h = HistoryBuffer(max_length=3)
    for i, v in enumerate([5.0, 1.0, 3.0, 7.0]):
        h.update(v, i)
    assert h.latest() == 7.0 and h.median(3) == 3.0 and h.avg(2) == 5.0
    assert h.global_avg() == 4.0 and [v for v, _ in h.values()] == [1.0, 3.0, 7.0]


def test_json_writer_records_equal_efg_tpu(tmp_path):
    """The same puts through both packages' storage and JSONWriter give the
    same lines; smoothed scalars are window medians, unsmoothed the latest."""
    files = []
    for Storage, Writer, name in ((JEventStorage, JJSONWriter, "jax"),
                                  (EventStorage, JSONWriter, "torch")):
        path = tmp_path / f"{name}.json"
        w = Writer(str(path), window_size=3)
        with Storage(0) as st:
            for it in range(5):
                st.iter = it
                st.put_scalars(loss=10.0 - it * 1.5 + (it % 2), grad_norm=float(it))
                st.put_scalar("lr", 0.1 * it, smoothing_hint=False)
                w.write()
        w.close()
        files.append(path.read_text())
    assert files[0] == files[1]
    last = json.loads(files[1].splitlines()[-1])
    assert last == {"iteration": 4, "loss": 6.5, "grad_norm": 3.0, "lr": pytest.approx(0.4)}


def test_prefetcher_on_cpu_wraps_numpy():
    batches = [{"x": np.arange(6, dtype=np.float32).reshape(2, 3) + i, "metadata": [i]}
               for i in range(3)]
    it = DevicePrefetcher(iter(batches), device="cpu")
    got = list(it)
    assert [b["metadata"] for b in got] == [[0], [1], [2]]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in got)
    np.testing.assert_array_equal(got[2]["x"].numpy(), batches[2]["x"])


# ----------------------------------------------------------------- trainer

class _Recorder(H.HookBase):
    def __init__(self, calls):
        self.calls = calls

    def before_train(self):
        self.calls.append("before_train")

    def before_step(self):
        self.calls.append(f"before_step {self.trainer.iter}")

    def after_step(self):
        self.calls.append(f"after_step {self.trainer.iter}")

    def after_train(self):
        self.calls.append("after_train")


def test_aug_fade_drops_the_leading_processor_and_restarts_the_stream():
    class Trainer:
        iter, device = 0, "cpu"

    class Dataset:
        transforms = ["gt_sampler", "flip"]

    t = Trainer()
    t.dataset = Dataset()
    t.dataloader = [{"x": np.zeros((2, 3), np.float32)} for _ in range(4)]
    t._data_iter = None
    hook = H.AugFadeHook(fade=0.5, max_iters=10)
    hook.trainer = t
    t.iter = 4
    hook.before_step()
    assert t.dataset.transforms == ["gt_sampler", "flip"] and t._data_iter is None
    t.iter = 5
    hook.before_step()
    assert t.dataset.transforms == ["flip"]
    assert isinstance(t._data_iter, DevicePrefetcher)
    assert isinstance(next(t._data_iter)["x"], torch.Tensor)
    t.iter = 6
    hook.before_step()  # once only
    assert t.dataset.transforms == ["flip"]


def test_loop_equals_train_step_by_hand(tmp_path):
    """DefaultTrainer.train() for 3 iterations against train_step driven by
    hand on the same batches from the same weights: every metric of every
    step and the final weights equal bit for bit; the record at iteration
    k holds step k−1's metrics; hooks run in order; checkpoints land."""
    trainer = _trainer(tmp_path / "loop", ["solver.lr_scheduler.max_iters=3",
                                           "trainer.checkpoint_iter=2"])
    calls = []
    trainer.hooks = H.attach(trainer, trainer.hooks + [_Recorder(calls)])
    assert [type(h).__name__ for h in trainer.hooks] == [
        "IterTimer", "LRSchedulerHook", "PeriodicWriter", "PeriodicCheckpoint", "_Recorder"]

    cfg = _config(tmp_path / "hand", ["solver.lr_scheduler.max_iters=3"])
    md = cli.load_experiment_module(CONFIG).build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(cfg.misc.seed))
    for (n, a), b in zip(md.module.state_dict().items(), trainer.state.module.state_dict().values()):
        assert torch.equal(a, b), n
    sched = dict(cfg.solver.lr_scheduler, lr=cfg.solver.optimizer.lr)
    tx = build_optimizer(cfg.solver.optimizer, *build_scheduler(sched),
                         grad_clip_cfg=cfg.solver.grad_clipper)
    state = init_state(md, tx)
    loader = iter(build_dataloader(cfg, build_dataset(cfg)))
    want = []
    for _ in range(3):
        batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                 for k, v in next(loader).items()}
        want.append({k: float(v) for k, v in train_step(md, tx, state, batch).items()})

    trainer.train()
    recs = _records(tmp_path / "loop" / "metrics.json")
    assert sorted(recs) == [1, 2, 3]
    for it, w in enumerate(want, start=1):
        got = {k: v for k, v in recs[it].items() if k in w}
        assert got == w, (it, got, w)
    assert set(recs[1]) == set(want[0]) | {"iteration", "lr"}
    for (n, a), b in zip(md.module.state_dict().items(), trainer.state.module.state_dict().values()):
        assert torch.equal(a, b), n
    assert calls == ["before_train"] + [f"{p} {i}" for i in range(3)
                                        for p in ("before_step", "after_step")] + ["after_train"]
    assert sorted(os.listdir(tmp_path / "loop")) == [
        "metrics.json", "model_0000001", "model_final"]



def test_train_holds_cudnn_to_deterministic_algorithms(tmp_path, monkeypatch):
    """Every step of DefaultTrainer.train() runs with
    torch.backends.cudnn.deterministic set (a resumed run repeats the
    uninterrupted one on the card), and train() restores the caller's
    setting afterwards, also when a step raises."""
    seen = []

    def step(model_def, tx, state, batch, seed=0):
        seen.append(torch.backends.cudnn.deterministic)
        state.step += 1
        return {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.0)}

    monkeypatch.setattr(T, "train_step", step)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    trainer = _trainer(tmp_path / "a", ["solver.lr_scheduler.max_iters=2"])
    trainer.train()
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic is False

    def failing(*args, **kwargs):
        raise RuntimeError("step failed")

    monkeypatch.setattr(T, "train_step", failing)
    trainer = _trainer(tmp_path / "b", ["solver.lr_scheduler.max_iters=2"])
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.train()
    assert torch.backends.cudnn.deterministic is False

def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint then resume_or_load into a fresh trainer: module
    (parameters and BN statistics), AdamW moments and count, step."""
    a = _trainer(tmp_path, ["solver.lr_scheduler.max_iters=2", "trainer.checkpoint_period=100"])
    a.train()
    assert sorted(os.listdir(tmp_path)) == ["metrics.json", "model_final"]
    b = _trainer(tmp_path, ["solver.lr_scheduler.max_iters=2", "misc.seed=5"])
    assert not torch.equal(b.state.module.backbone.down1.weight, a.state.module.backbone.down1.weight)
    b.resume_or_load(resume=True)
    assert b.start_iter == b.iter == b.state.step == 2 and b.dataloader.start_batch == 2
    for (n, x), y in zip(a.state.module.state_dict().items(), b.state.module.state_dict().values()):
        assert torch.equal(x, y), n
    oa, ob = a.state.opt_state, b.state.opt_state
    assert oa.count == ob.count == 2
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x, y)
    assert any(float(m.abs().max()) > 0 for m in ob.mu)


def test_resume_continuity_bit_for_bit(tmp_path):
    """Run A trains 6 iterations with a checkpoint after step 3; model_final
    is removed; a fresh process resumes from the step-3 checkpoint and its
    records 4-6 equal A's bit for bit."""
    cache = tmp_path / "run"
    opts = ["solver.lr_scheduler.max_iters=6", "trainer.checkpoint_iter=3"]
    subprocess.run(_cli_cmd(*opts), cwd=ROOT, env=_cli_env(cache), check=True, timeout=600,
                   capture_output=True)
    out = _out(cache)
    full = _records(out / "metrics.json")
    assert sorted(full) == list(range(1, 7))
    assert sorted(os.listdir(out))[-2:] == ["model_0000002", "model_final"]
    (out / "model_final").unlink()
    subprocess.run(_cli_cmd(*opts, resume=True), cwd=ROOT, env=_cli_env(cache), check=True,
                   timeout=600, capture_output=True)
    with open(out / "metrics.json") as f:
        lines = [json.loads(line) for line in f]
    assert sum(1 for r in lines if r["iteration"] == 6) == 2  # the resumed run appended
    resumed = _records(out / "metrics.json")  # the resumed run's records win
    for it in (4, 5, 6):
        assert resumed[it] is not full[it]
        assert {k: v for k, v in resumed[it].items() if k != "time"} == \
            {k: v for k, v in full[it].items() if k != "time"}, it
    resumed_lines = lines[len(full) + 1:]
    assert [r["iteration"] for r in resumed_lines] == [3, 4, 5, 6]


def test_sigterm_preemption_checkpoint_and_resume(tmp_path):
    """SIGTERM mid-training: rc 0, a step checkpoint, no model_final; a
    --resume relaunch restores it and finishes."""
    cache = tmp_path / "run"
    out = _out(cache)
    proc = subprocess.Popen(_cli_cmd("solver.lr_scheduler.max_iters=50"), cwd=ROOT,
                            env=_cli_env(cache), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if (out / "metrics.json").exists() and len(_records(out / "metrics.json")) >= 1:
                break
            assert proc.poll() is None, "train exited before it could be preempted"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0
    ckpts = sorted(f for f in os.listdir(out) if f.startswith("model_"))
    assert len(ckpts) == 1 and ckpts[0] != "model_final", ckpts
    step = int(ckpts[0][len("model_"):])
    assert 2 <= step < 50
    subprocess.run(_cli_cmd(f"solver.lr_scheduler.max_iters={step + 2}", resume=True), cwd=ROOT,
                   env=_cli_env(cache), check=True, timeout=600, capture_output=True)
    recs = _records(out / "metrics.json")
    assert max(recs) == step + 2 and np.isfinite([r["loss"] for r in recs.values()]).all()
    assert "model_final" in os.listdir(out)


# ------------------------------------------------------ not ported: raises

@pytest.mark.parametrize("opts, exc, match", [
    # every evaluator efg_tpu registers is ported: PanopticEvaluator builds
    # (its host code would see 3D batches only at evaluate)
    pytest.param(["trainer.evaluators=[PanopticEvaluator]"], None, "PanopticEvaluator",
                 id="opts0-trainer.evaluators"),
    # a data axis of 2 in a world of one rank: the mesh does not fit the
    # ranks, which raises as efg_tpu's build_mesh does
    pytest.param(["mesh.shape=[2,1]"], AssertionError, r"mesh shape \[2, 1\] != 1 devices",
                 id="opts1-mesh does not fit the ranks"),
    # the default format, `resnet`, is ported: the missing file raises when
    # it is opened, as in efg_tpu
    pytest.param(["model.weights=/some/backbone.pth"], FileNotFoundError,
                 "/some/backbone.pth", id="opts2-weight import"),
    # the swin format too (ported): the missing file raises when it is opened
    pytest.param(["model.weights=/some/backbone.pth", "model.weights_format=swin"],
                 FileNotFoundError, "/some/backbone.pth", id="opts2-weight import swin"),
    pytest.param(["mesh.shape=[1,2]"], NotImplementedError, "tensor parallelism.*item 5",
                 id="opts3-tensor parallelism"),
])
def test_unported_requests_raise(tmp_path, opts, exc, match):
    if exc is None:
        from efg_tpu_torch.evaluator.build import build_evaluators

        t = _trainer(tmp_path, opts)
        t.resume_or_load(resume=False)
        assert [type(e).__name__ for e in build_evaluators(t.config, t.dataset)] == [match]
        return
    with pytest.raises(exc, match=match):
        _trainer(tmp_path, opts).resume_or_load(resume=False)


def test_cli_refusals(tmp_path, monkeypatch):
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    base = ["--config", CONFIG, "--device", "cpu"]
    # a name efg_tpu does not register either raises its registry's KeyError
    with pytest.raises(KeyError, match="COCOPanopticEvaluator"):
        cli.main(base + ["task=val", "trainer.evaluators=[COCOPanopticEvaluator]"])
    with pytest.raises(ValueError, match="Unknown task"):
        cli.main(base + ["task=predict"])
    with pytest.raises(ValueError, match="--num-machines 2 needs --dist-url"):
        cli.main(base + ["--num-machines", "2", "task=train"])
    # every playground experiment has a port net.py: an experiment made here has none
    other = tmp_path / "playground" / "detection.3d" / "synthetic" / "no_such.experiment"
    other.mkdir(parents=True)
    (other / "config.yaml").write_text(Path(CONFIG).read_text())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.load_experiment_module(str(other / "config.yaml"))
    t = _trainer(tmp_path, ["model.weights=/some/backbone.pth"])
    with pytest.raises(FileNotFoundError, match="/some/backbone.pth"):
        t.resume_or_load(resume=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config", CONFIG, "task=train", *SMALL])


# -------------------------------------------------------------- evaluation

def _capture_evaluations(monkeypatch):
    """Every `DefaultTrainer.evaluate` call's (trainer iteration, results)."""
    calls = []
    evaluate = T.DefaultTrainer.evaluate

    def wrapped(self, evaluators=None):
        res = evaluate(self, evaluators)
        calls.append((self.iter, self.state.step, res))
        return res

    monkeypatch.setattr(T.DefaultTrainer, "evaluate", wrapped)
    return calls


def test_cli_train_evaluates_then_val_from_checkpoint(tmp_path, monkeypatch):
    """The experiment's config.yaml as written names WaymoDetEvaluator: the
    CLI trains, then evaluates (efg_tpu's result keys); `task=val` restores
    model_final and evaluates the same weights on the same frames to the
    same results."""
    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    calls = _capture_evaluations(monkeypatch)
    base = ["--config", CONFIG, "--device", "cpu"]
    assert cli.main(base + ["task=train", *EVAL_SMALL, "solver.lr_scheduler.max_iters=2"]) == 0
    assert cli.main(base + ["task=val", *EVAL_SMALL]) == 0
    assert sorted(os.listdir(_out(tmp_path))) == ["log.txt.rank0", "metrics.json", "model_final"]
    (_, step_train, after_train), (_, step_val, val) = calls
    assert step_train == step_val == 2
    cfg = Configuration(config_file=CONFIG, opts=EVAL_SMALL).get_config()
    assert list(cfg.trainer.evaluators) == ["WaymoDetEvaluator"]
    with warnings.catch_warnings():  # efg_tpu's nanmean over no frames
        warnings.simplefilter("ignore", RuntimeWarning)
        assert set(after_train) == set(JWaymoDetEvaluator(cfg, None).evaluate())
    assert len(after_train) == 3 * 2 * 2 + 1
    assert all(np.isfinite(v) for v in after_train.values())
    assert val == after_train
    with open(_out(tmp_path) / "log.txt.rank0") as f:
        log = f.read()
    assert log.count("Waymo eval over 4 frames") == 2
    assert log.count("Evaluation results: {'waymo/VEHICLE/L1/AP'") == 2


@pytest.mark.parametrize("max_iters, period", [(30, 16), (30, 15), (7, 1), (8, 4), (5, 0)])
def test_eval_hook_fires_as_efg_tpu(max_iters, period):
    """The iterations after which EvalHook evaluates: efg_tpu's rule."""
    fired = []
    for Hook, Storage in ((JEvalHook, JEventStorage), (H.EvalHook, EventStorage)):
        class Trainer:
            pass

        t = Trainer()
        t.max_iters = max_iters
        its = []
        hook = Hook(period, lambda: its.append(storage.iter))
        hook.trainer = t
        with Storage(0) as storage:
            for it in range(max_iters):
                storage.iter = it
                hook.after_step()
        fired.append(its)
    assert fired[0] == fired[1]
    assert fired[1] == [it for it in range(max_iters - 1) if period and (it + 1) % period == 0]


def test_eval_and_profiler_hooks_in_the_loop(tmp_path, monkeypatch):
    """trainer.eval_period and trainer.profiler add ProfilerHook and EvalHook
    in efg_tpu's order; the loop evaluates after iteration period − 1
    (period = eval_period × iterations per epoch) and not after the last;
    the profiler writes a Chrome trace of its window on the CPU."""
    calls = []  # evaluate() itself: test_cli_train_evaluates_then_val_from_checkpoint
    monkeypatch.setattr(T.DefaultTrainer, "evaluate",
                        lambda self, evaluators=None: calls.append((self.iter, self.state.step)))
    t = _trainer(tmp_path, [*EVAL_SMALL, "trainer.evaluators=[WaymoDetEvaluator]",
                            "solver.lr_scheduler.max_iters=4",
                            "trainer.eval_period=1.0", "trainer.checkpoint_period=100",
                            "trainer.profiler={start_iter: 1, num_iters: 1}"])
    assert [type(h).__name__ for h in t.hooks] == [
        "IterTimer", "LRSchedulerHook", "ProfilerHook", "PeriodicWriter", "PeriodicCheckpoint",
        "EvalHook"]
    assert t.iters_per_epoch == 2 and t.hooks[-1]._period == 2
    t.train()
    assert calls == [(1, 2)]
    prof = t.hooks[2]
    assert prof.trace_path == str(tmp_path / "profile" / "trace_1_2.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)  # no device on the CPU
    for prof_opt, window in (("true", (10, 15)), ("{start_iter: 3}", (3, 8))):
        hook = _trainer(tmp_path, [f"trainer.profiler={prof_opt}"]).hooks[2]
        assert isinstance(hook, H.ProfilerHook) and (hook._start, hook._stop) == window


# ------------------------------------------------------- initial weights

def test_initial_weights_from_an_explicit_generator():
    """VoxelNet(generator=...): the same seed gives equal state_dicts,
    another seed differs, and torch's global RNG is left untouched."""
    kw = dict(pc_range=(-6.4, -6.4, -2.0, 6.4, 6.4, 4.0), max_voxels=256,
              neck_cfg=(("layer_nums", (1, 1)), ("ds_num_filters", (32, 64)),
                        ("us_num_filters", (32, 32))), device="cpu")
    before = torch.get_rng_state()
    a, b, c = (VoxelNet(generator=torch.Generator().manual_seed(s), **kw) for s in (7, 7, 8))
    assert torch.equal(torch.get_rng_state(), before)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    weights = [n for n in sa if n.endswith("weight") and sa[n].dim() >= 3]
    assert len(weights) == 21 + 6 + 11  # sparse convs, RPN convs, head convs
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
    assert all(not torch.equal(sa[n], sc[n]) for n in weights)
    assert not torch.equal(sa["head.task0.hm_final.weight"], sc["head.task0.hm_final.weight"])
    VoxelNet(**kw)  # without a generator: torch's global RNG, as before
    assert not torch.equal(torch.get_rng_state(), before)
