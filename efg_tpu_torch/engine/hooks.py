"""Trainer hooks: host-side callbacks around the train step (port of
`efg_tpu/engine/hooks.py`).

As in efg_tpu, the backward, the clip and the optimizer update belong to
the step (`engine/trainer.py` `train_step`), not to a hook. `EvalHook`
runs the trainer's evaluation every `period` iterations; `ProfilerHook`
traces a window of iterations with `torch.profiler` where efg_tpu uses
`jax.profiler`.
"""

from __future__ import annotations

import logging
import os
import time
import weakref
from typing import List, Optional

from efg_tpu_torch.utils.events import EventWriter, get_event_storage
from efg_tpu_torch.utils.logger import LOGGER_NAME
from efg_tpu_torch.utils.timer import Timer


class HookBase:
    trainer = None  # weakref proxy, set by the trainer

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterTimer(HookBase):
    """Per-iteration wall time ("time"), after `warmup_iter` iterations."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._step_timer = Timer()
        self._start_time = time.perf_counter()
        self._total_timer = Timer()

    def before_train(self):
        self._start_time = time.perf_counter()
        self._total_timer.reset()
        self._total_timer.pause()

    def after_train(self):
        storage = get_event_storage()
        total_time = time.perf_counter() - self._start_time
        total_compute = self._total_timer.seconds()
        num_iter = storage.iter - self.trainer.start_iter - self._warmup_iter
        if num_iter > 0 and total_compute > 0:
            logging.getLogger(LOGGER_NAME).info(
                f"Total training time: {total_time:.1f}s; "
                f"{total_compute / num_iter:.4f} s/it over {num_iter} iters"
            )

    def before_step(self):
        self._step_timer.reset()
        self._total_timer.resume()

    def after_step(self):
        storage = get_event_storage()
        if storage.iter - self.trainer.start_iter >= self._warmup_iter:
            storage.put_scalar("time", self._step_timer.seconds(), smoothing_hint=True)
        else:
            self._start_time = time.perf_counter()
            self._total_timer.reset()
        self._total_timer.pause()


class LRSchedulerHook(HookBase):
    """Log the scheduled LR each step (the optimizer evaluates the
    schedule itself)."""

    def __init__(self, lr_schedule):
        self._lr_schedule = lr_schedule

    def after_step(self):
        storage = get_event_storage()
        lr = float(self._lr_schedule(storage.iter))
        storage.put_scalar("lr", lr, smoothing_hint=False)


class PeriodicWriter(HookBase):
    """Flush writers every `period` iterations and at the last one."""

    def __init__(self, writers: List[EventWriter], period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        storage = get_event_storage()
        if (storage.iter + 1) % self._period == 0 or (
            storage.iter == self.trainer.max_iters - 1
        ):
            for w in self._writers:
                w.write()

    def after_train(self):
        for w in self._writers:
            w.write()
            w.close()


class PeriodicCheckpoint(HookBase):
    """Save `model_{iter:07d}` after every `period`-th iteration (iter is
    0-based, so the file after the 15th step is model_0000014) and
    `model_final` after training. The saves are asynchronous: the file is
    written behind the next steps, and `train()` waits for it before it
    returns. The trainer adds this hook on rank 0 only."""

    def __init__(self, period: int):
        self._period = max(1, int(period))

    def after_step(self):
        it = get_event_storage().iter
        if (it + 1) % self._period == 0 and it != self.trainer.max_iters - 1:
            self.trainer.save_checkpoint(f"model_{it:07d}", blocking=False)

    def after_train(self):
        # a preempted run is NOT final: it already saved a step checkpoint,
        # and writing model_final here would make the resumed run look done
        if getattr(self.trainer, "_preempted", False):
            return
        self.trainer.save_checkpoint("model_final", blocking=False)


class EvalHook(HookBase):
    """Evaluate after every `period`-th iteration but the last one (the
    CLI evaluates after training). Every rank runs it: each evaluates its
    shard and the evaluators gather the frames."""

    def __init__(self, period: int, eval_fn):
        self._period = int(period)
        self._eval_fn = eval_fn

    def after_step(self):
        it = get_event_storage().iter
        if self._period > 0 and (it + 1) % self._period == 0 and it != self.trainer.max_iters - 1:
            self._eval_fn()


class AugFadeHook(HookBase):
    """Drop the leading data processor (GT-database sampling) for the last
    `fade` fraction of training, and restart the prefetcher on the new
    stream."""

    def __init__(self, fade: float, max_iters: int):
        self._fade_start = int(max_iters * (1.0 - fade))
        self._faded = False

    def before_step(self):
        t = self.trainer
        if not self._faded and t.iter >= self._fade_start:
            ds = t.dataset
            if getattr(ds, "transforms", None):
                from efg_tpu_torch.data.prefetcher import DevicePrefetcher

                ds.transforms = ds.transforms[1:]
                t._data_iter = DevicePrefetcher(iter(t.dataloader), device=t.device)
            self._faded = True
            logging.getLogger(LOGGER_NAME).info(
                f"Aug fade at iter {t.iter}: dropped leading processor"
            )


class ProfilerHook(HookBase):
    """A `torch.profiler` trace of iterations [`start_iter`, `start_iter +
    num_iters`): host activity, and the device's kernels and copies when
    the trainer runs on the card. The Chrome trace is written to
    `<out_dir>/profile/trace_{start}_{stop}.json` when the window closes,
    or after training if it ends inside the window."""

    def __init__(self, out_dir: str, start_iter: int = 10, num_iters: int = 5):
        self._dir = os.path.join(out_dir, "profile")
        self._start = int(start_iter)
        self._stop = int(start_iter) + max(1, int(num_iters))
        self._prof = None
        self.trace_path: Optional[str] = None

    def before_step(self):
        if self._prof is None and self.trainer.iter == self._start:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.trainer.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()

    def _finish(self):
        if self._prof is None:
            return
        self._prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        self.trace_path = os.path.join(self._dir, f"trace_{self._start}_{self._stop}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        logging.getLogger(LOGGER_NAME).info(f"Profiler trace written to {self.trace_path}")

    def after_step(self):
        if self._prof is not None and self.trainer.iter + 1 >= self._stop:
            self._finish()

    def after_train(self):
        self._finish()


def attach(trainer, hooks: List[Optional[HookBase]]) -> List[HookBase]:
    hooks = [h for h in hooks if h is not None]
    for h in hooks:
        h.trainer = weakref.proxy(trainer)
    return hooks
