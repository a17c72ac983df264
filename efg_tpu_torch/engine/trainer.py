"""The train and eval steps and the hook-driven trainer around them (port
of `efg_tpu/engine/trainer.py`).

efg_tpu jits its steps; here they run eagerly. `DefaultTrainer` is
efg_tpu's loop: data, optimizer, state and hooks set up from the config,
checkpoints as `torch.save` files written behind the next steps, resume
with the data stream fast-forwarded, a SIGTERM handler that checkpoints
at the next step boundary, metrics fetched one step late, and `evaluate`:
the eval step over the val split, its outputs fed to the config's
evaluators.

Under data parallelism (`parallel/ddp.py`, ranks started by
`engine/launch.py`) every rank holds the whole model and trains on its
slice of the machine's batch. The BN statistics and the loss normalisers
are the global batch's, each rank's gradient is its share of the gradient
of the ranks' summed loss, and `train_step` sums the gradients over the
ranks (one flat all-reduce per dtype after the backward, not a
`DistributedDataParallel` wrapper: ConQueR's loss calls submodules and
the EMA decoder outside the module's forward, and leaves some parameters
without a gradient) before the clip and the optimizer see them. So every rank
applies efg_tpu's global-batch update, and the replicas stay equal bit
for bit. Rank 0 writes the records and the checkpoints.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import logging
import math
import os
import signal
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from efg_tpu_torch.data.builder import build_dataloader, build_dataset
from efg_tpu_torch.data.prefetcher import DevicePrefetcher
from efg_tpu_torch.engine.hooks import (
    AugFadeHook,
    EvalHook,
    HookBase,
    IterTimer,
    LRSchedulerHook,
    PeriodicCheckpoint,
    PeriodicWriter,
    ProfilerHook,
    attach,
)
from efg_tpu_torch.engine.train_state import ModelDef, TrainState
from efg_tpu_torch.evaluator.build import build_evaluators
from efg_tpu_torch.models.centerpoint import resolve_device
from efg_tpu_torch.parallel import ddp
from efg_tpu_torch.solver.optimizers import build_optimizer, global_norm
from efg_tpu_torch.solver.schedulers import build_scheduler
from efg_tpu_torch.utils import distributed as comm
from efg_tpu_torch.utils.events import (
    CommonMetricPrinter,
    EventStorage,
    JSONWriter,
    TensorboardWriter,
)
from efg_tpu_torch.utils.logger import LOGGER_NAME
from efg_tpu_torch.utils.registry import Registry

logger = logging.getLogger(LOGGER_NAME)
TRAINERS = Registry("trainers")


def init_state(model_def: ModelDef, tx) -> TrainState:
    module = model_def.module
    return TrainState(step=0, module=module, opt_state=tx.init(list(module.parameters())),
                      ema=model_def.ema_init(module) if model_def.ema_init else None)


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """A bijective 64-bit mix whose every output bit depends on every input
    bit (SplitMix64's finaliser)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """The torch.Generator of one training step on `device`, seeded from
    (seed, step): efg_tpu's `fold_in(key(seed), step)`, so a resumed run
    draws the noise an uninterrupted one draws. `stream` 1 is the loss's
    (efg_tpu's `fold_in(rng, 1)`), apart from the model's draws (stream
    0: dropout, drop path, ConQueR's denoising noise). The three are mixed
    into all 64 bits of the seed: the CPU generator (mt19937) reads only
    its low 32, the card's (Philox) all 64."""
    key = ((seed & 0x7FFFFFFF) << 33) | ((stream & 1) << 32) | (step & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(_splitmix64(key))


@functools.lru_cache(maxsize=None)
def _declares(fn, name: str) -> bool:
    """Whether callable `fn` has a parameter `name` (efg_tpu's
    `loss_takes_rng` test), read once per callable."""
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _train_mode(state: TrainState):
    """The module in train mode (batch statistics; the BN running stats
    update as a side effect), its parameters' grads cleared."""
    module = state.module
    module.train()
    for p in module.parameters():
        p.grad = None
    return module


def train_forward(model_def: ModelDef, state: TrainState, batch: Dict[str, Any],
                  generator: Optional[torch.Generator] = None):
    """Forward in train mode, with the parameters' grads cleared first;
    `generator`, when given, is passed on to the module (a forward that
    declares it: Swin's drop path)."""
    module = _train_mode(state)
    kwargs = model_def.apply_args(batch)
    if generator is not None:
        kwargs["generator"] = generator
    return module(**kwargs)


def apply_grads(tx, state: TrainState) -> torch.Tensor:
    """`tx` (clip + AdamW or SGD) on the grads the backward left, in place; a
    parameter without a grad counts as a zero grad. Returns the global norm
    before clipping."""
    params: List[torch.Tensor] = list(state.module.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    grad_norm = global_norm(grads)
    tx.step(params, grads, state.opt_state, grad_norm=grad_norm)
    state.step += 1
    return grad_norm


def train_step(model_def: ModelDef, tx, state: TrainState, batch: Dict[str, Any],
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """One training step: `train_forward` and `loss_fn` (the forward given
    the step's generator when its module declares one, the loss the
    step's loss stream when it declares `rng`), or the ModelDef's
    `custom_loss` (module in train mode, grads cleared, the EMA state and
    the step's generator, `step_generator(seed, state.step)`), then the
    backward, the gradients summed over the ranks, `apply_grads` and
    `ema_update`. Returns the detached losses summed over the ranks (the
    global batch's) plus `grad_norm`, the global norm before clipping.
    Leaves the module in train mode and this step's grads on the
    parameters."""
    if model_def.custom_loss is not None:
        module = _train_mode(state)
        device = next(module.parameters()).device
        _, losses = model_def.custom_loss(module, state.ema, batch,
                                          step_generator(seed, state.step, device))
    else:
        device = next(state.module.parameters()).device
        takes = _declares(type(state.module).forward, "generator")
        preds = train_forward(model_def, state, batch,
                              step_generator(seed, state.step, device) if takes else None)
        if _declares(model_def.loss_fn, "rng"):  # the loss draws (Mask2Former's points)
            losses = model_def.loss_fn(preds, batch,
                                       rng=step_generator(seed, state.step, device, stream=1))
        else:
            losses = model_def.loss_fn(preds, batch)
    losses["loss"].backward()
    ddp.reduce_gradients(state.module)
    grad_norm = apply_grads(tx, state)
    if model_def.ema_update is not None and state.ema is not None:
        model_def.ema_update(state.ema, state.module)
    metrics = ddp.sum_metrics({k: v.detach() for k, v in losses.items()})
    metrics["grad_norm"] = grad_norm
    return metrics


@torch.inference_mode()
def eval_step(model_def: ModelDef, batch: Dict[str, Any]):
    """One serving step: forward in eval mode (running BN statistics), then
    `predict_fn` when the model has one. Puts the module in eval mode."""
    model_def.module.eval()
    preds = model_def.module(**model_def.apply_args(batch))
    if model_def.predict_fn is None:
        return preds
    return model_def.predict_fn(preds, batch)


def check_machine_batch(batch_size: int, local_ranks: int) -> None:
    """Refuse a machine's `dataloader.batch_size` that its local ranks
    cannot split evenly. A deviation from efg_tpu, which checks the batch
    against its data mesh axis, every machine's devices
    (`efg_tpu/engine/trainer.py:86-90`): with several machines efg_tpu
    refuses a batch that is not a multiple of all of them, though its own
    `global_bs = bs × world_size` makes `batch_size` one machine's. The
    port checks it against the ranks that take its slices, this
    machine's; on one machine the two checks agree."""
    if batch_size % local_ranks:
        raise ValueError(
            f"dataloader.batch_size={batch_size} must divide the data mesh axis ({local_ranks} "
            "ranks on this machine; efg_tpu checks it against every machine's devices, the "
            "port against this machine's ranks, which take its slices)")


@TRAINERS.register()
class DefaultTrainer:
    """efg_tpu's `DefaultTrainer` on this rank's device. `build_model(config,
    device=, generator=)` returns the ModelDef; its initial weights are
    drawn from a torch.Generator seeded by `misc.seed` (0 when unset),
    as efg_tpu initialises from `jax.random.key(seed)`, the same on every
    rank (checked at set-up). `resume`: the caller restores output_dir's
    newest checkpoint (`resume_or_load(resume=True)`), so where one exists
    the ModelDef's `init_params` is not applied: the checkpoint holds the
    weights."""

    def __init__(self, config, build_model, device="cuda", resume=False):
        self.config = config
        self.device = resolve_device(device)
        self._resume = resume
        self._refuse_unported()
        self.seed = max(0, int(config.misc.get("seed", 0) or 0))
        self.generator = torch.Generator().manual_seed(self.seed)
        self.model_def: ModelDef = build_model(config, device=self.device,
                                               generator=self.generator)

        self.setup_data()
        self.setup_optimizer()
        self.setup_state()
        self.setup_hooks()

        self.start_iter = 0
        self.iter = 0
        self._preempted = False
        self._ckpt_write: Optional[_CheckpointWrite] = None

    def _refuse_unported(self):
        """Raise on a request this port cannot serve, before any set-up: a
        mesh that does not fit the ranks (`ddp.mesh_shape`, which also
        refuses a `model` axis)."""
        ddp.mesh_shape(dict(self.config.get("mesh") or {}), comm.get_world_size())

    # ------------------------------------------------------------------ data
    def setup_data(self):
        cfg = self.config
        self.dataset = build_dataset(cfg)
        self.dataloader = build_dataloader(cfg, self.dataset, train=cfg.task == "train")
        self._data_iter = None

        # epoch → iteration conversion
        sched = cfg.solver.lr_scheduler
        bs = int(cfg.dataloader.batch_size)  # a machine's, as in efg_tpu
        global_bs = bs * comm.get_num_machines()
        self.iters_per_epoch = max(1, len(self.dataset) // global_bs)
        if sched.get("max_iters") or 0:
            self.max_iters = int(sched.max_iters)
        elif sched.get("max_epochs") or 0:
            self.max_iters = int(sched.max_epochs * self.iters_per_epoch)
        else:
            self.max_iters = 1
        sched["max_iters"] = self.max_iters

        check_machine_batch(bs, comm.get_local_size())

    # ----------------------------------------------------------------- model
    def setup_optimizer(self):
        cfg = self.config.solver
        sched_cfg = dict(cfg.lr_scheduler)
        sched_cfg["lr"] = cfg.optimizer.lr
        self.lr_schedule, self.momentum_schedule = build_scheduler(sched_cfg)
        self.tx = build_optimizer(cfg.optimizer, self.lr_schedule, self.momentum_schedule,
                                  grad_clip_cfg=cfg.get("grad_clipper"),
                                  module=self.model_def.module)

    def _checkpoints(self) -> List[str]:
        out = self.output_dir
        return sorted(f for f in os.listdir(out)
                      if f.startswith("model_") and os.path.isfile(os.path.join(out, f)))

    def setup_state(self):
        """The train state from the built module, after the ModelDef's
        `init_params` (efg_tpu applies it to the initialised parameters,
        `efg_tpu/engine/trainer.py:130-131`); each rank applies it, before
        the check that the ranks' weights are equal. A run that will resume
        a checkpoint skips it."""
        init_params = self.model_def.init_params
        if init_params is not None and not (self._resume and self._checkpoints()):
            init_params(self.model_def.module)
            logger.info("Applied the model's init_params to its initial weights")
        self.state: TrainState = init_state(self.model_def, self.tx)
        n_params = sum(p.numel() for p in self.state.module.parameters())
        logger.info(f"Model parameters: {n_params / 1e6:.2f}M on {self.device}")
        ddp.check_replicas_equal(self.state.module, "initial weights", self.state.ema)

    # ----------------------------------------------------------------- hooks
    def setup_hooks(self):
        cfg = self.config.trainer
        out_dir = self.output_dir
        writers = []
        if comm.is_main_process():
            writers.append(CommonMetricPrinter(self.max_iters, window_size=int(cfg.window_size)))
            writers.append(JSONWriter(os.path.join(out_dir, "metrics.json"), int(cfg.window_size)))
            if cfg.get("tensorboard", False):
                writers.append(TensorboardWriter(out_dir, int(cfg.window_size)))
        ckpt_period = cfg.get("checkpoint_iter") or None
        if ckpt_period is None and cfg.get("checkpoint_epoch"):
            ckpt_period = int(cfg.checkpoint_epoch * self.iters_per_epoch)
        if ckpt_period is None:
            ckpt_period = int(cfg.get("checkpoint_period", 10000))
        prof = cfg.get("profiler")  # e.g. {start_iter: 10, num_iters: 5} or true
        if prof is True:
            prof = {}
        elif not isinstance(prof, dict):
            prof = None  # absent / false / null: no profiling
        eval_period = cfg.get("eval_period")
        hooks: List[Optional[HookBase]] = [
            IterTimer(),
            LRSchedulerHook(self.lr_schedule),
            ProfilerHook(out_dir, int(prof.get("start_iter", 10)), int(prof.get("num_iters", 5)))
            if prof is not None and comm.is_main_process() else None,
            AugFadeHook(float(cfg.fade), self.max_iters) if cfg.get("fade") else None,
            PeriodicWriter(writers, period=int(cfg.log_interval)) if writers else None,
            PeriodicCheckpoint(ckpt_period) if comm.is_main_process() else None,
            EvalHook(int(eval_period * self.iters_per_epoch), self.evaluate)
            if eval_period and cfg.get("evaluators") else None,
        ]
        self.hooks = attach(self, hooks)

    @property
    def output_dir(self) -> str:
        d = self.config.trainer.output_dir
        os.makedirs(d, exist_ok=True)
        return d

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, name: str, blocking: bool = True) -> str:
        """Save the module's state_dict (parameters and BN statistics),
        the optimizer state by parameter name, the step, and the EMA state
        where the model has one, to `<output_dir>/<name>`. Host copies of
        all of it are complete when this returns, so the next step may
        update the tensors in place; `torch.save` then writes them under a
        temporary name, renamed when done, so a half-written checkpoint is
        never resumed. With `blocking=False` the write runs on a thread
        behind the next steps (one write at a time: a save first waits for
        the previous one); `wait_for_checkpoints` raises if it failed."""
        self.wait_for_checkpoints()
        path = os.path.join(self.output_dir, name)
        names = [n for n, _ in self.state.module.named_parameters()]
        opt = self.state.opt_state
        snapshot = {
            "model": _host_copy(self.state.module.state_dict()),
            "optimizer": {"count": opt.count,
                          **{f: _host_copy(dict(zip(names, tensors)))
                             for f, tensors in _opt_tensors(opt).items()}},
            "step": self.state.step,
            **({"ema": _host_copy(self.state.ema)} if self.state.ema is not None else {}),
        }
        tmp = os.path.join(self.output_dir, f".{name}.{os.getpid()}.tmp")
        if blocking:
            _write_checkpoint(snapshot, tmp, path)
            logger.info(f"Saved checkpoint to {path}")
        else:
            self._ckpt_write = _CheckpointWrite(snapshot, tmp, path)
            self._ckpt_write.start()
            logger.info(f"Saving checkpoint to {path} (async)")
        return path

    def wait_for_checkpoints(self) -> None:
        """Block until the checkpoint write in flight (if any) is on disk;
        raise if it failed."""
        write, self._ckpt_write = self._ckpt_write, None
        if write is None:
            return
        write.join()
        if write.error is not None:
            raise RuntimeError(f"writing checkpoint {write.path} failed") from write.error

    def resume_or_load(self, resume: bool = True):
        """Resume from the newest `model_*` checkpoint of output_dir, or
        load the checkpoint named by `model.weights`. A `.pth` / `.pkl`
        there (a `://` zoo URI resolves through `utils/catalog.py` and its
        download cache) is a reference checkpoint: it initialises the
        weights by `model.weights_format` (`_import_weights`) and is not a
        resume point. The data stream is
        fast-forwarded to the restored step: the loader discards the first
        `step` batches of sampler indices, and per-item seeding makes the
        rest of the stream equal to an uninterrupted run's. A write in
        flight is waited for, and every rank reads the same file behind a
        barrier (rank 0 wrote it)."""
        self.wait_for_checkpoints()
        comm.synchronize()
        out = self.output_dir
        ckpts = self._checkpoints()
        path = None
        if resume and ckpts:
            path = os.path.join(out, ckpts[-1])
        elif self.config.model.get("weights"):
            path = str(self.config.model.weights)
            if "://" in path:
                from efg_tpu_torch.utils.catalog import PathManager  # registers the handlers

                path = PathManager.get_local_path(path)
        if not path:
            return
        if path.endswith((".pth", ".pkl")):
            self._import_weights(path)
            return
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        module, opt = self.state.module, self.state.opt_state
        module.load_state_dict(ckpt["model"])
        with torch.no_grad():
            for f, tensors in _opt_tensors(opt).items():
                for i, (n, _) in enumerate(module.named_parameters()):
                    tensors[i].copy_(ckpt["optimizer"][f][n])
        opt.count = int(ckpt["optimizer"]["count"])
        if self.state.ema is not None:
            if set(ckpt.get("ema", {})) != set(self.state.ema):
                raise KeyError(f"{path}: its EMA state does not match the model's")
            with torch.no_grad():
                for n, e in self.state.ema.items():
                    e.copy_(ckpt["ema"][n])
        self.state.step = int(ckpt["step"])
        self.start_iter = self.iter = self.state.step
        self.dataloader.start_batch = self.start_iter
        logger.info(f"Restored checkpoint {path} at step {self.start_iter}")

    def _import_weights(self, path: str) -> None:
        """Initialise the model from the reference checkpoint at `path`
        (efg_tpu's `.pth`/`.pkl` branch of `resume_or_load`), by
        `model.weights_format`: `centerpoint` (a whole CenterPoint
        VoxelNet), `swin` (an mmdet / official Swin under
        `model.weights_prefix`) or, for any other value as in efg_tpu,
        `resnet`: a torchvision ResNet under `model.weights_prefix`."""
        from efg_tpu_torch.utils import torch_import as TI

        prefix = self.config.model.get("weights_prefix", "backbone")
        fmt = self.config.model.get("weights_format", "resnet")
        sd = TI.load_state_dict(path)
        if fmt == "swin":
            n, skipped = TI.import_swin(sd, self.state.module, prefix)
        elif fmt == "centerpoint":
            n, skipped = TI.import_centerpoint_voxelnet(sd, self.state.module)
        else:
            n, skipped = TI.import_torchvision_resnet(sd, self.state.module, prefix)
        logger.info(f"Imported {n} tensors from {path} (prefix '{prefix}'); "
                    f"skipped {len(skipped)}: {skipped[:8]}")

    # ----------------------------------------------------------------- train
    def _install_preemption_handler(self):
        """SIGTERM sets a flag; the loop saves a step checkpoint at the next
        step boundary and stops, so a `--resume` relaunch continues the same
        run. The ranks agree on the stop at each step boundary (a flag on
        any rank stops all of them), so none is left waiting in a
        collective. Returns the previous handler, or None when not
        installable (outside the main thread)."""
        self._preempted = False

        def _on_term(signum, frame):
            self._preempted = True

        try:
            return signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not in the main thread
            return None

    def _fetch(self, metrics: Dict[str, torch.Tensor]):
        """Start the metrics' copy to the host: on the card a non_blocking
        copy into pinned memory behind this step's work, so that reading
        them a step later waits for this step only."""
        keys = list(metrics)
        if self.device.type != "cuda":
            return keys, metrics, None
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return keys, host, done

    def train(self):
        """The loop, with cuDNN held to deterministic algorithms: its
        default fp32 weight-gradient algorithms (the heads' final convs)
        sum in an order that changes from call to call, and a `--resume`
        run then drifts from the uninterrupted one, where efg_tpu's XLA
        step repeats bit for bit. The previous setting is restored."""
        logger.info(f"Starting training: {self.max_iters} iters "
                    f"({self.iters_per_epoch} it/epoch) on {self.device}")
        prev_handler = self._install_preemption_handler()
        prev_deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            self._train_loop()
        finally:
            torch.backends.cudnn.deterministic = prev_deterministic
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _train_loop(self):
        with EventStorage(self.iter) as self.storage:
            for h in self.hooks:
                h.before_train()
            self._data_iter = DevicePrefetcher(iter(self.dataloader), device=self.device)
            pending = None  # (iter, fetched metrics): read one step late
            while self.iter < self.max_iters:
                for h in self.hooks:
                    h.before_step()
                device_batch = next(self._data_iter)
                metrics = train_step(self.model_def, self.tx, self.state, device_batch,
                                     seed=self.seed)
                if pending is not None:
                    self._write_metrics(*pending)
                pending = (self.iter, self._fetch(metrics))
                self.storage.iter = self.iter
                for h in self.hooks:
                    h.after_step()
                self.iter += 1
                self.storage.step()
                if comm.any_rank(self._preempted):
                    self._preempted = True
                    logger.warning(
                        f"SIGTERM: saving preemption checkpoint at iter {self.iter} and exiting")
                    if comm.is_main_process():
                        self.save_checkpoint(f"model_{self.iter:07d}")
                    break
            self._data_iter.close()
            if pending is not None:
                self._write_metrics(*pending)
            for h in self.hooks:
                h.after_train()
            self.wait_for_checkpoints()  # no exit with a write in flight

    def _write_metrics(self, it: int, fetched):
        keys, vals, done = fetched
        if done is None:
            host = {k: float(vals[k]) for k in keys}
        else:
            done.synchronize()
            host = dict(zip(keys, vals.tolist()))
        loss = host.get("loss", 0.0)
        if not math.isfinite(loss):
            raise FloatingPointError(
                f"Loss became infinite or NaN at iteration={it}! metrics={host}"
            )
        cur = self.storage.iter
        self.storage.iter = it
        self.storage.put_scalars(**host)
        self.storage.iter = cur

    # ------------------------------------------------------------------ eval
    def evaluate(self, evaluators=None):
        """The eval step over the val split (a copy of the config with task
        `val`, read in order), each batch's outputs moved to host numpy and
        fed with the host batch to the evaluators (the config's when none
        are given); returns their merged results. Under data parallelism
        each rank runs the bare module over its slice of each batch; a
        batch that does not split evenly over the local ranks comes padded
        by the loader, as efg_tpu pads a batch to its data axis, and the
        padding rows are trimmed from the outputs here. The evaluators
        gather every rank's frames."""
        cfg = self.config
        eval_cfg = type(cfg)(dict(cfg))
        eval_cfg["task"] = "val"
        dataset = build_dataset(eval_cfg)
        loader = build_dataloader(eval_cfg, dataset, train=False)
        evaluators = evaluators or build_evaluators(cfg, dataset)
        for ev in evaluators:
            ev.reset()
        n_batches = len(loader)
        n, n_valid = loader.local_batch, loader.local_valid
        for i, batch in enumerate(loader):
            if n_valid == 0:  # this rank's slice is padding only
                continue
            device_batch = {k: torch.from_numpy(v).to(self.device) if isinstance(v, np.ndarray)
                            else v for k, v in batch.items()}
            outputs = _to_numpy(eval_step(self.model_def, device_batch))
            if n_valid < n:
                outputs, batch = _trim(outputs, n, n_valid), _trim(batch, n, n_valid)
            for ev in evaluators:
                ev.process(batch, outputs)
            if (i + 1) % 50 == 0:
                logger.info(f"Inference {i + 1}/{n_batches}")
        results = {}
        for ev in evaluators:
            r = ev.evaluate()
            if r:
                results.update(r)
        if comm.is_main_process():
            logger.info(f"Evaluation results: {results}")
        return results


def _trim(tree, n: int, keep: int):
    """The first `keep` rows of every array and list of `n` rows in a
    dict tree (the other entries as they are)."""
    if isinstance(tree, dict):
        return {k: _trim(v, n, keep) for k, v in tree.items()}
    rows = isinstance(tree, list) or (isinstance(tree, np.ndarray) and tree.ndim >= 1)
    if rows and len(tree) == n:
        return tree[:keep]
    return tree


def _opt_tensors(opt_state) -> Dict[str, List[torch.Tensor]]:
    """The optimizer state's per-parameter tensor lists by field name
    (AdamW's `mu` and `nu`, SGD's `trace`)."""
    return {f.name: getattr(opt_state, f.name) for f in dataclasses.fields(opt_state)
            if isinstance(getattr(opt_state, f.name), list)}


def _host_copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies of a dict of tensors, complete on return (a copy even
    of a CPU tensor, which the next step updates in place)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _write_checkpoint(snapshot: Dict[str, Any], tmp: str, path: str) -> None:
    torch.save(snapshot, tmp)
    os.replace(tmp, path)


class _CheckpointWrite(threading.Thread):
    """One checkpoint file written on a thread of its own; its exception,
    if any, is kept for `DefaultTrainer.wait_for_checkpoints`."""

    def __init__(self, snapshot: Dict[str, Any], tmp: str, path: str):
        super().__init__(name="checkpoint-write")
        self.path = path
        self.error: Optional[BaseException] = None
        self._job = (snapshot, tmp, path)

    def run(self) -> None:
        try:
            _write_checkpoint(*self._job)
        except Exception as e:  # re-raised by the next wait
            self.error = e
        finally:
            self._job = None  # the host copies go with the thread


def _to_numpy(tree):
    """Tensors of a dict / list / tuple tree → host numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def build_trainer(config, build_model, device="cuda", resume=False):
    """The trainer `trainer.type` names (DefaultTrainer by default)."""
    kind = config.trainer.get("type", "DefaultTrainer")
    return TRAINERS.get(kind)(config, build_model, device=device, resume=resume)
