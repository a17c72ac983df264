"""Index samplers (port of the samplers of
`efg_tpu/data/samplers/dataset_sampler.py` that the port's runs use).

The distributed samplers shard by machine, as efg_tpu's shard by process
(one process a machine there): every local rank of a machine reads the
machine's stream, and the loader (`data/builder.py`) hands each its slice
of every batch.
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
        super().__init__(size, shuffle=shuffle, seed=seed, rank=comm.get_machine_rank(),
                         world_size=comm.get_num_machines())


@SAMPLERS.register()
class SeqInferenceSampler:
    """Whole sequences per machine, each sequence's frames in index order,
    so that a tracker sees a sequence's frames in turn. `sequence_ids`
    names each index's sequence (None: one sequence). The eval loader
    passes the dataset's `sequence_ids` (efg_tpu's passes none)."""

    def __init__(self, size: int, sequence_ids=None):
        rank, world = comm.get_machine_rank(), comm.get_num_machines()
        if sequence_ids is None:
            sequence_ids = [0] * size
        seqs = {}
        for i, s in enumerate(sequence_ids):
            seqs.setdefault(s, []).append(i)
        mine = sorted(seqs)[rank::world]
        self._local = [i for s in mine for i in seqs[s]]

    def __len__(self) -> int:
        return len(self._local)

    def __iter__(self) -> Iterator[int]:
        return iter(self._local)


@SAMPLERS.register()
class InferenceSampler:
    """One pass, contiguous per-machine shards."""

    def __init__(self, size: int):
        rank, world = comm.get_machine_rank(), comm.get_num_machines()
        shard = size // world
        left = size % world
        begin = shard * rank + min(rank, left)
        end = begin + shard + (1 if rank < left else 0)
        self._local = list(range(begin, end))

    def __len__(self) -> int:
        return len(self._local)

    def __iter__(self) -> Iterator[int]:
        return iter(self._local)
