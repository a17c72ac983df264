"""Index samplers (port of the samplers of
`efg_tpu/data/samplers/dataset_sampler.py` that a single-card run uses).

The distributed samplers shard by this process's rank and the world size
(`utils/distributed.py`: one process until data parallelism is ported).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from efg_tpu_torch.data.registry import SAMPLERS
from efg_tpu_torch.utils import distributed as comm


@SAMPLERS.register()
class InfiniteSampler:
    """Infinite shuffled index stream over [0, size)."""

    def __init__(self, size: int, shuffle: bool = True, seed: Optional[int] = None,
                 rank: int = 0, world_size: int = 1):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._seed = 2**31 - 1 if seed is None else int(seed)
        self._rank = rank
        self._world = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self._seed)
        while True:
            order = g.permutation(self._size) if self._shuffle else np.arange(self._size)
            yield from order[self._rank :: self._world].tolist()


@SAMPLERS.register()
class DistributedInfiniteSampler(InfiniteSampler):
    def __init__(self, size: int, shuffle: bool = True, seed: Optional[int] = None):
        super().__init__(size, shuffle=shuffle, seed=seed, rank=comm.get_rank(),
                         world_size=comm.get_world_size())


@SAMPLERS.register()
class InferenceSampler:
    """One pass, contiguous per-process shards."""

    def __init__(self, size: int):
        rank, world = comm.get_rank(), comm.get_world_size()
        shard = size // world
        left = size % world
        begin = shard * rank + min(rank, left)
        end = begin + shard + (1 if rank < left else 0)
        self._local = list(range(begin, end))

    def __len__(self) -> int:
        return len(self._local)

    def __iter__(self) -> Iterator[int]:
        return iter(self._local)
