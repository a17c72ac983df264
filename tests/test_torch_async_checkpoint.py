"""Asynchronous checkpoint writes and the TensorBoard writer, on the CPU.

The trainer runs the synthetic experiment's data (2048-point scenes)
through a tiny model with an EMA copy of its weights, so that a step costs
milliseconds and each test stays near a second: the checkpoint machinery
(host copies, the write thread, the wait, resume) does not depend on the
model. `_write_checkpoint` is slowed or broken by monkeypatching to show
that the loop goes on while a file is written, that a failed write raises
at the next wait, and that a resume from a file written behind the loop
is bit-exact. `TensorboardWriter`'s scalars, images and histograms are
read back with tensorboard's `EventAccumulator`.
"""

import os
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import efg_tpu_torch.data  # noqa: F401  (registrations)
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.engine import trainer as T
from efg_tpu_torch.engine.hooks import HookBase
from efg_tpu_torch.engine.train_state import ModelDef
from efg_tpu_torch.utils.events import EventStorage, TensorboardWriter
from efg_tpu_torch.utils.seed import seed_all_rng

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml")
SMALL = ["trainer.evaluators=", "dataset.points_per_frame=2048",
         "dataset.processors.train[5].PadPoints.num_points=2048", "trainer.log_interval=1",
         "trainer.window_size=1", "solver.lr_scheduler.max_iters=6", "trainer.checkpoint_iter=2"]


class _Tiny(nn.Module):
    """Per-frame point statistics → a linear layer; a BN-like buffer."""

    def __init__(self, generator):
        super().__init__()
        self.lin = nn.Linear(5, 3)
        with torch.no_grad():
            self.lin.weight.copy_(torch.randn(3, 5, generator=generator))
            self.lin.bias.copy_(torch.randn(3, generator=generator))
        self.register_buffer("running", torch.zeros(3))

    def forward(self, points, points_mask):
        m = points_mask.to(points.dtype)[..., None]
        feats = (points * m).sum(1) / m.sum(1).clamp(min=1)
        out = self.lin(feats)
        if self.training:
            with torch.no_grad():
                self.running.mul_(0.9).add_(0.1 * out.mean(0))
        return out


def _build_tiny(config, device, generator):
    module = _Tiny(generator).to(device)

    def loss_fn(preds, batch):
        target = batch["gt_boxes"][:, :3, :3].mean(1)
        return {"loss": ((preds - target) ** 2).mean()}

    def ema_init(mod):
        return {n: p.detach().clone() for n, p in mod.named_parameters()}

    @torch.no_grad()
    def ema_update(ema, mod):
        for n, p in mod.named_parameters():
            ema[n].mul_(0.9).add_(0.1 * p)

    return ModelDef(module, lambda b: dict(points=b["points"], points_mask=b["points_mask"]),
                    loss_fn=loss_fn, ema_init=ema_init, ema_update=ema_update)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _tensorboard_without_tensorflow():
    """tensorboard's own no-TensorFlow mode (`tensorboard.compat.notf`):
    it reads and writes event files with its stub instead of importing
    TensorFlow where that is installed, which alone takes about 15 s."""
    name = "tensorboard.compat.notf"
    had = sys.modules.get(name)
    sys.modules[name] = had or types.ModuleType(name)
    yield
    if had is None:
        sys.modules.pop(name)


def _trainer(out_dir, opts=()):
    cfg = Configuration(config_file=CONFIG, opts=SMALL + list(opts)).get_config()
    cfg["trainer"]["output_dir"] = str(out_dir)
    seed_all_rng(cfg.misc.seed)
    return T.DefaultTrainer(cfg, _build_tiny, device="cpu")


class _StepTimes(HookBase):
    def __init__(self):
        self.ends = {}

    def after_step(self):
        self.ends[self.trainer.iter] = time.monotonic()


def _state(t):
    s = {f"model.{k}": v.clone() for k, v in t.state.module.state_dict().items()}
    s.update({f"ema.{k}": v.clone() for k, v in t.state.ema.items()})
    s.update({f"mu.{i}": v.clone() for i, v in enumerate(t.state.opt_state.mu)})
    s.update({f"nu.{i}": v.clone() for i, v in enumerate(t.state.opt_state.nu)})
    return s


def test_async_save_writes_behind_the_loop(tmp_path, monkeypatch):
    """With every write slowed by 0.5 s, the steps after a periodic save
    end before its file is written; once `train()` returns every file is
    complete (its step, weights and EMA load) and no write is in flight.
    TensorBoard, asked for by the config, wrote its event file."""
    writes = []
    real = T._write_checkpoint

    def slow(snapshot, tmp, path):
        start = time.monotonic()
        time.sleep(0.5)
        real(snapshot, tmp, path)
        writes.append((os.path.basename(path), start, time.monotonic(),
                       threading.current_thread() is threading.main_thread()))

    monkeypatch.setattr(T, "_write_checkpoint", slow)
    t = _trainer(tmp_path, ["trainer.tensorboard=true"])
    steps = _StepTimes()
    t.hooks.append(steps)
    steps.trainer = t
    t.train()
    assert t._ckpt_write is None
    assert [w[0] for w in writes] == ["model_0000001", "model_0000003", "model_final"]
    assert not any(w[3] for w in writes)  # written on the write thread
    name, start, end, _ = writes[0]
    assert steps.ends[2] < end, (steps.ends, writes[0])
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("model_")) == [
        "model_0000001", "model_0000003", "model_final"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    final = torch.load(tmp_path / "model_final", weights_only=True)
    assert final["step"] == 6 and set(final["ema"]) == {"lin.weight", "lin.bias"}
    for k, v in t.state.module.state_dict().items():
        assert torch.equal(final["model"][k], v), k
    first = torch.load(tmp_path / "model_0000001", weights_only=True)
    assert first["step"] == 2 and first["optimizer"]["count"] == 2
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))


def test_failed_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    """A write that fails on its thread raises in `wait_for_checkpoints`
    (its error chained), and a training run whose periodic write fails
    raises at the next save, which waits for it first."""
    def broken(snapshot, tmp, path):
        raise OSError("no space left on device")

    monkeypatch.setattr(T, "_write_checkpoint", broken)
    t = _trainer(tmp_path)
    t.save_checkpoint("model_9999999", blocking=False)
    with pytest.raises(RuntimeError, match="writing checkpoint .*model_9999999 failed") as e:
        t.wait_for_checkpoints()
    assert isinstance(e.value.__cause__, OSError)
    t.wait_for_checkpoints()  # reported once
    with pytest.raises(RuntimeError, match="failed"):
        t.train()
    assert not [f for f in os.listdir(tmp_path) if f.startswith("model_")]


def test_resume_from_an_async_checkpoint_is_bit_exact(tmp_path):
    """A run resumed from the checkpoint written behind step 2 ends with
    the weights, BN-like buffer, EMA and AdamW moments of the uninterrupted
    run, bit for bit, and writes the same records for steps 3-6."""
    a = _trainer(tmp_path / "a")
    a.train()
    os.makedirs(tmp_path / "b")
    os.link(tmp_path / "a" / "model_0000001", tmp_path / "b" / "model_0000001")
    b = _trainer(tmp_path / "b")
    b.resume_or_load(resume=True)
    assert b.start_iter == 2
    b.train()
    want, got = _state(a), _state(b)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k

    def records(d):
        import json
        with open(d / "metrics.json") as f:
            return {r["iteration"]: r for r in map(json.loads, f) if "loss" in r}

    ra, rb = records(tmp_path / "a"), records(tmp_path / "b")
    assert sorted(rb) == [3, 4, 5, 6]
    for it in rb:
        assert rb[it]["loss"] == ra[it]["loss"] and rb[it]["grad_norm"] == ra[it]["grad_norm"]


def test_tensorboard_writer_round_trip(tmp_path):
    """Scalars (smoothed as the JSON writer smooths them), a CHW float
    image, an HWC uint8 image and a histogram, written at two iterations,
    read back from the event file; the queues are drained by each write."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    w = TensorboardWriter(str(tmp_path), window_size=1)
    with EventStorage(0) as storage:
        storage.put_scalars(loss=1.5, lr=0.01)
        storage.put_image("chw", np.linspace(0, 1, 3 * 4 * 6, dtype=np.float32).reshape(3, 4, 6))
        storage.put_image("hwc", np.full((5, 7, 3), 200, np.uint8))
        storage.put_histogram("weights", np.arange(100, dtype=np.float32), bins=10)
        w.write()
        assert storage._vis_data == [] and storage._histograms == []
        storage.step()
        storage.put_scalars(loss=0.5, lr=0.02)
        w.write()
    w.close()
    ea = EventAccumulator(str(tmp_path), size_guidance={"images": 0, "histograms": 0})
    ea.Reload()
    assert [(e.step, e.value) for e in ea.Scalars("loss")] == [(0, 1.5), (1, 0.5)]
    assert [e.value for e in ea.Scalars("lr")] == pytest.approx([0.01, 0.02])
    (chw,), (hwc,) = ea.Images("chw"), ea.Images("hwc")
    assert (chw.width, chw.height, hwc.width, hwc.height) == (6, 4, 7, 5)
    (hist,) = ea.Histograms("weights")
    h = hist.histogram_value
    assert (h.min, h.max, h.num, h.sum) == (0.0, 99.0, 100, 4950.0)
    assert h.bucket == [10.0] * 10
