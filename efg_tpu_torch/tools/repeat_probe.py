"""Which parameters' gradients change from one run of a training step to
the next, on the same batch and the same weights.

    python -m efg_tpu_torch.tools.repeat_probe --config <config.yaml> \
        [--device cuda] [--repeats 3] [--no-tf32] [dotlist overrides ...]

Builds the experiment's trainer as `task=train` does (evaluators off,
output under a temporary directory), takes its first batch, and runs
`train_step` `--repeats` times, each on a copy of the initial state:
first with cuDNN's default algorithms, then with
`torch.backends.cudnn.deterministic` set, as `DefaultTrainer.train` sets
it. `--no-tf32` turns TF32 off for matmuls and cuDNN first. Prints one
JSON line a setting: the parameters whose gradient differs from the first
run's, each with its largest difference over the gradient's largest
magnitude, and whether the losses differ.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import sys
import tempfile


def _run(model_def, tx, state, batch, seed):
    import torch

    from efg_tpu_torch.engine.trainer import train_step

    st = copy.deepcopy(state)
    metrics = train_step(model_def, tx, st, batch, seed=seed)
    grads = {n: p.grad.detach().clone() for n, p in st.module.named_parameters()
             if p.grad is not None}
    return {k: v.detach().clone() for k, v in metrics.items() if torch.is_tensor(v)}, grads


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--no-tf32", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import torch

    import efg_tpu_torch.data  # noqa: F401  (registrations)
    from efg_tpu_torch.cli.main import load_experiment_module
    from efg_tpu_torch.config import Configuration
    from efg_tpu_torch.data.prefetcher import DevicePrefetcher
    from efg_tpu_torch.engine.trainer import build_trainer
    from efg_tpu_torch.utils.seed import seed_all_rng

    if args.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = Configuration(config_file=args.config,
                           opts=["task=train", "trainer.evaluators=", *args.opts]).get_config()
    out_dir = tempfile.mkdtemp(prefix="repeat_probe_")
    config["trainer"]["output_dir"] = out_dir
    try:
        seed_all_rng(max(0, int(config.misc.get("seed", 0) or 0)))
        trainer = build_trainer(config, load_experiment_module(args.config).build_model,
                                device=args.device)
        prefetcher = DevicePrefetcher(iter(trainer.dataloader), device=trainer.device)
        batch = next(prefetcher)
        prefetcher.close()
        previous = torch.backends.cudnn.deterministic
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            runs = [_run(trainer.model_def, trainer.tx, trainer.state, batch, trainer.seed)
                    for _ in range(args.repeats)]
            (losses0, grads0), differ, loss_differ = runs[0], {}, set()
            for losses, grads in runs[1:]:
                loss_differ |= {k for k in losses0 if not torch.equal(losses0[k], losses[k])}
                for n, g in grads.items():
                    if not torch.equal(g, grads0[n]):
                        rel = float((g - grads0[n]).abs().max() / grads0[n].abs().max())
                        differ[n] = max(differ.get(n, 0.0), rel)
            print(json.dumps({
                "cudnn_deterministic": deterministic, "repeats": args.repeats,
                "tf32": not args.no_tf32, "device": str(trainer.device),
                "parameters": len(grads0), "losses_differ": sorted(loss_differ),
                "grads_differ": dict(sorted(differ.items(), key=lambda kv: -kv[1])),
            }), flush=True)
        torch.backends.cudnn.deterministic = previous
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
