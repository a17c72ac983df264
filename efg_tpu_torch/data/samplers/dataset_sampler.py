"""Index samplers (port of `efg_tpu/data/samplers/dataset_sampler.py`).

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


@SAMPLERS.register()
class DistributedGroupSampler:
    """Infinite aspect-ratio-grouped sampler: every run of
    `samples_per_batch` indices shares one aspect-ratio group (landscape
    or portrait), so one canvas a batch wastes less padding. Each epoch,
    each group's indices are shuffled, padded to a multiple of
    samples_per_batch·machines, cut into whole batches, and the batches'
    order is shuffled across groups; this machine's share is every
    machines-th batch. `aspect_ratios` holds each item's group id (the
    dataset's attribute of that name)."""

    def __init__(self, size: int, aspect_ratios=None, samples_per_batch: int = 1,
                 shuffle: bool = True, seed: Optional[int] = None):
        assert size > 0
        self._size = size
        self._ar = (np.zeros(size, np.int64) if aspect_ratios is None
                    else np.asarray(aspect_ratios, np.int64))
        if len(self._ar) != size:
            raise ValueError(f"{len(self._ar)} aspect ratios for {size} items")
        self._spb = max(int(samples_per_batch), 1)
        self._shuffle = shuffle
        self._seed = 2**31 - 1 if seed is None else int(seed)
        self._rank = comm.get_machine_rank()
        self._world = comm.get_num_machines()

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self._seed)
        while True:
            batches = []
            for grp in np.unique(self._ar):
                idx = np.nonzero(self._ar == grp)[0]
                if self._shuffle:
                    idx = idx[g.permutation(len(idx))]
                quantum = self._spb * self._world
                pad = (-len(idx)) % quantum
                if pad:
                    fill = idx[: pad % len(idx)] if pad <= len(idx) else np.resize(idx, pad)
                    idx = np.concatenate([idx, fill])
                batches.extend(idx.reshape(-1, self._spb))
            order = g.permutation(len(batches)) if self._shuffle else np.arange(len(batches))
            for bi in order[self._rank :: self._world]:
                yield from batches[bi].tolist()
