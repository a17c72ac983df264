"""Process identity and host-side collectives (port of
`efg_tpu/utils/distributed.py` on `torch.distributed`).

The port runs one process per rank: a card, or a CPU worker. Ranks are
grouped by machine, `get_local_size()` of them on each; efg_tpu runs one
process per machine, so its `jax.process_index()` / `process_count()` are
`get_machine_rank()` / `get_num_machines()` here. Python objects travel
pickled over a gloo side group, as the reference's did
(`efg/utils/distributed.py:107-229`), so gathering evaluator frames never
goes through the device. With no process group (`parallel/ddp.py` sets
one up) the world is this one process.
"""

from __future__ import annotations

import random
from typing import Any, List, Optional

import torch
import torch.distributed as dist

_LOCAL_RANK = 0
_LOCAL_SIZE = 1
_GLOO_GROUP: Optional[Any] = None  # the side group for objects and flags


def set_local(local_rank: int, local_size: int, gloo_group) -> None:
    """Record this rank's place on its machine and the gloo side group
    (called by `parallel/ddp.py` once the process group is up)."""
    global _LOCAL_RANK, _LOCAL_SIZE, _GLOO_GROUP
    _LOCAL_RANK, _LOCAL_SIZE, _GLOO_GROUP = int(local_rank), int(local_size), gloo_group


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    return _LOCAL_RANK if is_initialized() else 0


def get_local_size() -> int:
    """The ranks on this machine: the devices of the run that
    `jax.local_device_count()` reads in efg_tpu."""
    return _LOCAL_SIZE if is_initialized() else 1


def get_machine_rank() -> int:
    """efg_tpu's process index: the machine this rank runs on."""
    return get_rank() // get_local_size()


def get_num_machines() -> int:
    """efg_tpu's process count."""
    return get_world_size() // get_local_size()


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier over every rank (no-op in a world of one)."""
    if get_world_size() > 1:
        dist.barrier(group=_GLOO_GROUP)


def all_gather(data: Any) -> List[Any]:
    """Every rank's picklable `data`, in rank order: `[data]` in a world
    of one."""
    if get_world_size() == 1:
        return [data]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, data, group=_GLOO_GROUP)
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every rank's `data` on rank `dst`, in rank order; the others get []."""
    if get_world_size() == 1:
        return [data]
    out: Optional[List[Any]] = [None] * get_world_size() if get_rank() == dst else None
    dist.gather_object(data, out, dst=dst, group=_GLOO_GROUP)
    return out if get_rank() == dst else []


def shared_random_seed() -> int:
    """A random seed, rank 0's, on every rank (reference
    `distributed.py:252-262`)."""
    seed = [random.randint(0, 2**31 - 1)]
    if get_world_size() > 1:
        dist.broadcast_object_list(seed, src=0, group=_GLOO_GROUP)
    return int(seed[0])


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any: one host-side
    all-reduce over the side group, so no device work waits on it."""
    if get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_GLOO_GROUP)
    return bool(t.item())
