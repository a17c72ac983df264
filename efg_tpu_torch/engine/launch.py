"""The launcher: one process per rank (port of efg_tpu's multi-host
bring-up, `cli/main.py:57-78`, for a runtime of one process per card).

efg_tpu runs one process per machine over all its local devices. Here a
machine runs `local_ranks` processes (by default one per visible card; one
on the CPU), and rank = machine rank × local ranks + local rank. The
machines come, in efg_tpu's priority, from `--num-machines` /
`--machine-rank` / `--dist-url`, then from SLURM (one task per machine),
then from torchrun's environment. Under torchrun with `LOCAL_RANK` set,
torchrun has started every rank itself: this process is one of them and
nothing is spawned.

`spawn` starts the local ranks with the `spawn` start method, hands a
SIGTERM it receives to every rank (the trainer checkpoints and stops all
of them at the same step), and ends the others when one fails, so that
none waits forever in a collective.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import signal
import socket
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch


# seconds the other ranks get to stop after one failed, before SIGKILL: a
# rank waiting in a collective for the failed one never returns
GRACE_S = 30.0


@dataclasses.dataclass(frozen=True)
class RankSpec:
    rank: int
    world_size: int
    local_rank: int
    local_size: int
    backend: str  # nccl | gloo
    init_method: str  # tcp://host:port
    device: str


def _slurm_first_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, in-process (the reference shells
    out to `scontrol show hostname` — `efg/engine/launch.py:150`).

    Handles "host1,host2", "prefix[001-004,007]", "prefix[3]suffix"."""
    # cut at the first comma that is not inside brackets
    depth, first = 0, nodelist
    for i, ch in enumerate(nodelist):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            first = nodelist[:i]
            break
    lb = first.find("[")
    if lb == -1:
        return first
    rb = first.index("]", lb)
    token = first[lb + 1:rb].split(",")[0].split("-")[0]
    return first[:lb] + token + first[rb + 1:]


def resolve_distributed_env(args, env) -> tuple | None:
    """(coordinator_address, num_processes, process_id) for multi-host
    bring-up, or None for single-process.

    Priority mirrors the reference launchers (`efg/engine/launch.py:31-182`):
    explicit CLI flags, then SLURM env (SLURM_PROCID/SLURM_NTASKS/
    SLURM_NODELIST + MASTER_PORT, default 29500), then generic torchrun-style
    env (RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT)."""
    if args.num_machines > 1:
        return args.dist_url, args.num_machines, args.machine_rank
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        ntasks = int(env["SLURM_NTASKS"])
        if ntasks <= 1:
            return None
        addr = env.get("MASTER_ADDR") or _slurm_first_host(env["SLURM_NODELIST"])
        port = env.get("MASTER_PORT", "29500")
        return f"{addr}:{port}", ntasks, int(env["SLURM_PROCID"])
    if "RANK" in env and "WORLD_SIZE" in env and int(env["WORLD_SIZE"]) > 1:
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT", "29500")
        return f"{addr}:{port}", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def _tcp(addr: str) -> str:
    return addr if "://" in addr else f"tcp://{addr}"


def free_port() -> int:
    """A TCP port of this host that is free now: the rendezvous of a
    group whose ranks all run here."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plan(args, env) -> Tuple[List[RankSpec], bool]:
    """(the ranks this process runs, whether to spawn them). No ranks: a
    world of one, run in this process without a process group. `args`
    holds the CLI's num_machines, machine_rank, dist_url, local_ranks,
    dist_backend and device."""
    from efg_tpu_torch.models.centerpoint import resolve_device
    from efg_tpu_torch.parallel.ddp import rank_device

    resolve_device(args.device)  # raises when the card asked for is not there
    backend = args.dist_backend or ("nccl" if torch.device(args.device).type == "cuda"
                                    else "gloo")
    slurm = "SLURM_PROCID" in env and "SLURM_NTASKS" in env
    if args.num_machines <= 1 and not slurm and "LOCAL_RANK" in env and "RANK" in env:
        world = int(env.get("WORLD_SIZE", 1))
        if world <= 1:
            return [], False
        local = int(env["LOCAL_RANK"])
        addr = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env.get('MASTER_PORT', '29500')}"
        spec = RankSpec(int(env["RANK"]), world, local, int(env.get("LOCAL_WORLD_SIZE", 1)),
                        backend, _tcp(addr), str(rank_device(args.device, local)))
        return [spec], False

    cluster = resolve_distributed_env(args, env)
    if cluster is None:
        coordinator, machines, machine = None, 1, 0
    else:
        coordinator, machines, machine = cluster
        if not coordinator:
            raise ValueError(f"--num-machines {machines} needs --dist-url (the address of "
                             "machine 0, e.g. tcp://host:port)")
    if args.local_ranks is not None:
        local_size = int(args.local_ranks)
    elif torch.device(args.device).type == "cuda":
        local_size = torch.cuda.device_count()
    else:
        local_size = 1
    if local_size < 1:
        raise ValueError(f"--local-ranks {local_size}: at least one rank a machine")
    world = machines * local_size
    if world == 1:
        return [], False
    init = _tcp(coordinator) if coordinator else f"tcp://127.0.0.1:{free_port()}"
    specs = [RankSpec(machine * local_size + lr, world, lr, local_size, backend, init,
                      str(rank_device(args.device, lr))) for lr in range(local_size)]
    return specs, local_size > 1


def run_rank(fn: Callable, spec: RankSpec, args: Sequence = ()) -> int:
    """`fn(*args, device)` as rank `spec` in this process, inside the
    process group."""
    from efg_tpu_torch.parallel import ddp

    device = ddp.init_process_group(spec.backend, spec.init_method, spec.rank, spec.world_size,
                                    spec.device, spec.local_rank, spec.local_size)
    try:
        return fn(*args, device) or 0
    finally:
        ddp.destroy_process_group()


def _rank_main(fn: Callable, spec: RankSpec, args: Sequence) -> None:
    sys.exit(run_rank(fn, spec, args))


def spawn(fn: Callable, specs: Sequence[RankSpec], args: Sequence = ()) -> int:
    """Run `fn(*args, device)` as each of `specs`, one spawned process
    each, and wait for all. A SIGTERM to this process reaches every rank.
    When a rank fails the others get SIGTERM, and SIGKILL GRACE_S later.
    Returns 0, or the first non-zero exit code (128 + signal for a rank
    that a signal ended)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, s, tuple(args)), name=f"rank{s.rank}")
             for s in specs]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not in the main thread
        prev = None
    failed_at: Optional[float] = None
    try:
        while any(p.is_alive() for p in procs):
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = time.monotonic()
                forward(signal.SIGTERM, None)
            if failed_at is not None and time.monotonic() - failed_at > GRACE_S:
                for p in procs:
                    if p.is_alive():
                        p.kill()
            time.sleep(0.05)
        for p in procs:
            p.join()
    finally:
        for p in procs:  # this process is leaving early: leave no rank behind
            if p.is_alive():
                p.kill()
                p.join()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
    codes = [p.exitcode for p in procs]
    bad = next((c for c in codes if c), 0)
    return 128 - bad if bad < 0 else bad
