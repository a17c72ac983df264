"""Process identity (the single-process part of
`efg_tpu/utils/distributed.py`). The port runs one process on one card
until data parallelism is ported (ROADMAP queue 1), so the world has
size 1 and this process is its main process."""

from __future__ import annotations

from typing import Any, List


def get_world_size() -> int:
    return 1


def get_rank() -> int:
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def all_gather(obj: Any) -> List[Any]:
    """Every process's `obj`, in rank order: `[obj]` in a world of one."""
    return [obj]
