"""Device prefetcher (port of `efg_tpu/data/prefetcher.py`): keeps `depth`
batches in flight ahead of the consumer.

On the card each batch is copied from pinned host memory with
`non_blocking` copies on a side stream; the consumer's stream waits on
that copy's event before it reads the batch, and every tensor is recorded
on the consumer's stream so that its memory is not reused early. On the
CPU the numpy arrays are wrapped by `torch.from_numpy`. Entries that are
not arrays (metadata lists) pass through. Under data parallelism each rank
copies to its own card: the side stream, the pinned buffers and the event
belong to the prefetcher's device, whichever card is current.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator

import numpy as np
import torch


class DevicePrefetcher:
    def __init__(self, iterator: Iterator[Dict[str, Any]], device="cuda", depth: int = 2):
        self._it = iterator
        self._device = torch.device(device)
        self._depth = depth
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._queue: collections.deque = collections.deque()

    def _put(self, batch):
        if self._stream is None:
            return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                    for k, v in batch.items()}, None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(v).pin_memory().to(self._device, non_blocking=True)
                   if isinstance(v, np.ndarray) else v for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def __iter__(self):
        return self

    def close(self) -> None:
        """Close the source iterator (its worker threads stop)."""
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
        self._queue.clear()

    def __next__(self):
        while len(self._queue) < self._depth:
            try:
                self._queue.append(self._put(next(self._it)))
            except StopIteration:
                break
        if not self._queue:
            raise StopIteration
        batch, ready = self._queue.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
        return batch
