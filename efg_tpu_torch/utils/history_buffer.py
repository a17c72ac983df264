"""Scalar history with windowed smoothing (a copy of
`efg_tpu/utils/history_buffer.py`)."""

from __future__ import annotations

from typing import List, Optional, Tuple


class HistoryBuffer:
    """Tracks a series of scalar values with O(1) append and windowed stats."""

    def __init__(self, max_length: int = 1000000):
        self._max_length = max_length
        self._data: List[Tuple[float, float]] = []  # (value, iteration)
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None) -> None:
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        vals = sorted(v for v, _ in self._data[-window_size:])
        return vals[len(vals) // 2]

    def avg(self, window_size: int) -> float:
        vals = [v for v, _ in self._data[-window_size:]]
        return sum(vals) / len(vals)

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return self._data
