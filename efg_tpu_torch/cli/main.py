"""`efg_run_torch`: the port's entry point (port of `cli/main.py`).

    python -m efg_tpu_torch.cli.main --config <experiment>/config.yaml \\
        [--resume] [--device cpu] task=train|val|test <dotlist overrides>

The config is read as efg_run reads it (default.yaml ← config.yaml ←
overrides). The experiment's `build_model` comes from the port's counterpart of
its `net.py`, `efg_tpu_torch/playground/<experiment path>/net.py`, loaded
by file path. Output goes to `$EFG_CACHE_DIR/EFG_torch/<experiment path>`
(default cache `~/.efg_tpu/cache`), apart from efg_run's `EFG/` tree, with
a `log_torch` link in the experiment directory. `task=train` trains, then
evaluates with the config's `trainer.evaluators` unless the run was
preempted; `task=val|test` loads the newest checkpoint of the output
directory (or `model.weights`) and evaluates. Both run on the card unless
`--device cpu` is given.

Data parallelism (`engine/launch.py`): a machine runs one rank per visible
card (`--local-ranks N` to choose; one on the CPU), each on
`cuda:<local rank>`, over nccl; `--device cuda:0 --dist-backend gloo`
puts every local rank on one card. Several machines come from
`--num-machines N --machine-rank M --dist-url tcp://host:port`, SLURM or
torchrun's environment. `dataloader.batch_size` is a machine's batch, as
in efg_tpu; each local rank trains on its slice of it.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
from pathlib import Path

PORT_PLAYGROUND = Path(__file__).resolve().parents[1] / "playground"


def get_parser():
    parser = argparse.ArgumentParser(description="efg_tpu_torch runner")
    parser.add_argument("--config", default="config.yaml", help="experiment config path")
    parser.add_argument("--task", default=None, help="override config task: train|val|test")
    parser.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default=None, help="coordinator address for multi-host")
    parser.add_argument("--local-ranks", type=int, default=None,
                        help="ranks on this machine (default: one per visible card; 1 on the CPU)")
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="process group backend (default: nccl on cards, gloo on the CPU)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: cuda:<local rank>), cuda:N (every rank) or cpu")
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER,
        help="config overrides: a.b.c value or a.b=value",
    )
    return parser


def experiment_relpath(config_path: str) -> str:
    """The experiment directory's path below its last `playground`
    component (its own name when it has none)."""
    exp_dir = Path(config_path).resolve().parent
    parts = exp_dir.parts
    if "playground" in parts:
        last = len(parts) - 1 - parts[::-1].index("playground")
        return str(Path(*parts[last + 1:]))
    return exp_dir.name


def load_experiment_module(config_path: str):
    """The port's counterpart of the experiment's net.py."""
    rel = experiment_relpath(config_path)
    path = PORT_PLAYGROUND / rel / "net.py"
    if not path.is_file():
        raise NotImplementedError(
            f"experiment {rel!r} is not ported yet: efg_tpu_torch has no {path}")
    spec = importlib.util.spec_from_file_location("efg_tpu_torch_experiment_net", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup_output_dir(config, config_path: str) -> str:
    """Output under $EFG_CACHE_DIR/EFG_torch/<experiment-relpath>, with a
    ./log_torch link in the experiment directory."""
    cache = os.environ.get("EFG_CACHE_DIR", os.path.expanduser("~/.efg_tpu/cache"))
    out = os.path.join(cache, "EFG_torch", experiment_relpath(config_path))
    os.makedirs(out, exist_ok=True)
    config["trainer"]["output_dir"] = out
    link = os.path.join(os.path.dirname(os.path.abspath(config_path)), "log_torch")
    try:
        if os.path.islink(link):
            os.remove(link)
        if not os.path.exists(link):
            os.symlink(out, link)
    except OSError:  # a read-only experiment dir: the link is a convenience
        pass
    return out


def main(argv=None) -> int:
    from efg_tpu_torch.engine import launch

    args = get_parser().parse_args(argv)
    specs, spawn = launch.plan(args, os.environ)
    if not specs:
        return run(args, args.device)
    if spawn:
        return launch.spawn(run, specs, (args,))
    return launch.run_rank(run, specs[0], (args,))


def run(args, device) -> int:
    """The entry point's work in one rank (or the only process) on
    `device`."""
    import efg_tpu_torch.data  # noqa: F401  (registrations)
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.engine.trainer import build_trainer
    from efg_tpu_torch.models.centerpoint import resolve_device
    from efg_tpu_torch.utils import distributed as comm
    from efg_tpu_torch.utils.logger import setup_logger
    from efg_tpu_torch.utils.seed import seed_all_rng

    config = Configuration(config_file=args.config, opts=list(args.opts)).get_config()
    if args.task:
        config["task"] = args.task
    if config.task not in ("train", "val", "test"):
        raise ValueError(f"Unknown task {config.task}")
    device = resolve_device(device)

    out_dir = setup_output_dir(config, args.config)
    logger = setup_logger(out_dir, comm.get_rank())
    logger.info(f"Running with config: {args.config}; output: {out_dir}; device: {device}; "
                f"rank {comm.get_rank()} of {comm.get_world_size()}")

    # efg_tpu offsets the seed by its process index: the machine's rank
    seed = config.misc.get("seed", -1)
    seed = seed_all_rng(None if seed is None or seed < 0 else seed + comm.get_machine_rank())
    logger.info(f"Seed: {seed}")

    net = load_experiment_module(args.config)
    # task=val|test always restores the newest checkpoint
    resume = args.resume or config.task != "train"
    trainer = build_trainer(config, net.build_model, device=device, resume=resume)
    if config.task == "train":
        trainer.resume_or_load(resume=args.resume)
        trainer.train()
        if trainer._preempted:
            return 0  # preemption checkpoint saved; a --resume relaunch continues
        if config.trainer.get("evaluators"):
            trainer.evaluate()
    else:
        trainer.resume_or_load(resume=True)
        trainer.evaluate()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
