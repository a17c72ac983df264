"""Event storage and metric writers (port of `efg_tpu/utils/events.py`):
an in-memory `EventStorage` of scalars with smoothing windows, a JSON-lines
writer and a console printer with ETA, losses, lr and step time. Metrics
enter as Python floats, so the storage stays on the host.

The TensorBoard writer and the image and histogram queues that feed it
are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional

from efg_tpu_torch.utils.history_buffer import HistoryBuffer
from efg_tpu_torch.utils.logger import LOGGER_NAME

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() called outside an EventStorage context"
    return _CURRENT_STORAGE_STACK[-1]


class EventStorage:
    """Scalar store scoped to a training run."""

    def __init__(self, start_iter: int = 0, window_size: int = 20):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, float] = {}
        self._iter = start_iter
        self._window_size = window_size

    def put_scalar(self, name: str, value: float, smoothing_hint: bool = True) -> None:
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = value
        existing = self._smoothing_hints.get(name)
        if existing is not None and existing != smoothing_hint:
            raise ValueError(f"Scalar {name} was put with inconsistent smoothing_hint")
        self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"No history metric '{name}'")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest(self) -> Dict[str, float]:
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int) -> Dict[str, float]:
        out = {}
        for k, v in self._latest_scalars.items():
            out[k] = self._history[k].median(window_size) if self._smoothing_hints[k] else v
        return out

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, value: int) -> None:
        self._iter = value

    def step(self) -> None:
        self._iter += 1

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args) -> None:
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONWriter(EventWriter):
    """Append the latest (smoothed) scalars to a JSON-lines file, one
    record per write: {"iteration": storage.iter, name: value, ...}."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self._window_size = window_size

    def write(self) -> None:
        storage = get_event_storage()
        record = {"iteration": storage.iter}
        record.update(storage.latest_with_smoothing_hint(self._window_size))
        self._file.write(json.dumps(record, sort_keys=True) + "\n")
        self._file.flush()
        try:
            os.fsync(self._file.fileno())
        except OSError:
            pass

    def close(self) -> None:
        self._file.close()


class CommonMetricPrinter(EventWriter):
    """Console printer: eta, iteration, losses, lr, step time."""

    def __init__(self, max_iter: int, window_size: int = 20, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger(LOGGER_NAME)
        self._max_iter = max_iter
        self._window_size = window_size

    def write(self) -> None:
        storage = get_event_storage()
        iteration = storage.iter
        histories = storage.histories()

        data_time = time_str = eta_string = lr = None
        if "data_time" in histories:
            data_time = histories["data_time"].avg(self._window_size)
        if "time" in histories:
            iter_time = histories["time"].global_avg()
            time_str = f"time: {histories['time'].median(self._window_size):.4f}"
            eta_seconds = iter_time * (self._max_iter - iteration)
            eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
        if "lr" in histories:
            lr = f"{histories['lr'].latest():.2e}"

        losses = [
            f"{k}: {v.median(self._window_size):.4g}"
            for k, v in histories.items()
            if "loss" in k
        ]
        msg = (
            f"eta: {eta_string}  iter: {iteration}/{self._max_iter}  "
            + "  ".join(losses)
            + (f"  {time_str}" if time_str else "")
            + (f"  data_time: {data_time:.4f}" if data_time is not None else "")
            + (f"  lr: {lr}" if lr else "")
        )
        self.logger.info(msg)
