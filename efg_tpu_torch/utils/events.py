"""Event storage and metric writers (port of `efg_tpu/utils/events.py`):
an in-memory `EventStorage` of scalars with smoothing windows and queues
of images and histograms, a JSON-lines writer, a TensorBoard writer
(`torch.utils.tensorboard`, which needs the `tensorboard` package) and a
console printer with ETA, losses, lr and step time. Metrics enter as
Python floats and arrays as numpy, so the storage stays on the host.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from efg_tpu_torch.utils.history_buffer import HistoryBuffer
from efg_tpu_torch.utils.logger import LOGGER_NAME

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() called outside an EventStorage context"
    return _CURRENT_STORAGE_STACK[-1]


class EventStorage:
    """Scalar, image and histogram store scoped to a training run."""

    def __init__(self, start_iter: int = 0, window_size: int = 20):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, float] = {}
        self._iter = start_iter
        self._window_size = window_size
        self._vis_data: List[tuple] = []
        self._histograms: List[dict] = []

    def put_image(self, img_name: str, img_tensor) -> None:
        """Queue an image for TensorBoard: [C, H, W] or [H, W, C], uint8 or
        float, stored as a host array and drained by the TensorBoard
        writer at its next write."""
        self._vis_data.append((img_name, np.asarray(img_tensor), self._iter))

    def put_histogram(self, hist_name: str, hist_tensor, bins: int = 1000) -> None:
        """Queue a histogram for TensorBoard, its `add_histogram_raw`
        parameters computed here on the host."""
        x = np.asarray(hist_tensor, dtype=np.float64).reshape(-1)
        ht_min, ht_max = float(x.min()), float(x.max())
        counts, edges = np.histogram(x, bins=bins, range=(ht_min, ht_max))
        self._histograms.append(dict(
            tag=hist_name, min=ht_min, max=ht_max, num=len(x), sum=float(x.sum()),
            sum_squares=float((x ** 2).sum()), bucket_limits=edges[1:].tolist(),
            bucket_counts=counts.tolist(), global_step=self._iter))

    def clear_images(self) -> None:
        self._vis_data = []

    def clear_histograms(self) -> None:
        self._histograms = []

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


class TensorboardWriter(EventWriter):
    """The latest (smoothed) scalars, and the queued images and
    histograms, into a TensorBoard event file under `log_dir`. Building
    one without the `tensorboard` package raises its ImportError."""

    def __init__(self, log_dir: str, window_size: int = 20):
        from torch.utils.tensorboard import SummaryWriter

        self._window_size = window_size
        self._writer = SummaryWriter(log_dir)

    def write(self) -> None:
        import torch

        storage = get_event_storage()
        for k, v in storage.latest_with_smoothing_hint(self._window_size).items():
            self._writer.add_scalar(k, v, storage.iter)
        if storage._vis_data:
            for img_name, img, step_num in storage._vis_data:
                fmt = "HWC" if img.ndim == 3 and img.shape[-1] in (1, 3, 4) else "CHW"
                self._writer.add_image(img_name, torch.as_tensor(img), step_num, dataformats=fmt)
            storage.clear_images()
        if storage._histograms:
            for params in storage._histograms:
                self._writer.add_histogram_raw(**params)
            storage.clear_histograms()

    def close(self) -> None:
        self._writer.close()


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
