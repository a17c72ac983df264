"""Dataset, processor and dataloader construction (port of
`efg_tpu/data/builder.py`).

The loader emits numpy batches of static shapes (padded points + masks,
padded GT arrays), as efg_tpu's does; `data/prefetcher.py` moves them to
the device. Training reads through worker threads when
`dataloader.num_workers` > 0, evaluation in order. With a seed, every
item's augmentations draw from a numpy seed derived from the item's
ordinal in the stream, so a stream fast-forwarded by `start_batch` or
read by several workers yields the same batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from efg_tpu_torch.data.registry import DATASETS, PROCESSORS, SAMPLERS
from efg_tpu_torch.utils.seed import seed_all_rng


_GLOBAL_RNG_LOCK = threading.Lock()


def build_processors(processor_cfgs) -> List[Any]:
    """YAML list of `Name` or `{Name: kwargs}` → instances."""
    out = []
    for item in processor_cfgs:
        if isinstance(item, str):
            out.append(PROCESSORS.get(item)())
        else:
            (name, kwargs), = item.items()
            kwargs = dict(kwargs) if kwargs else {}
            out.append(PROCESSORS.get(name)(**kwargs))
    return out


def build_dataset(config):
    return DATASETS.get(config.dataset.type)(config)


def pad_gt(
    annotations: Optional[dict], max_gt: int, box_dim: int = 9
) -> Dict[str, np.ndarray]:
    """annotations {gt_boxes [G, D], labels [G]} → fixed [max_gt] arrays."""
    boxes = np.zeros((max_gt, box_dim), np.float32)
    classes = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    if annotations is not None and len(annotations.get("gt_boxes", [])) > 0:
        gb = np.asarray(annotations["gt_boxes"], np.float32)
        g = min(len(gb), max_gt)
        d = min(gb.shape[1], box_dim)
        boxes[:g, :d] = gb[:g, :d]
        if gb.shape[1] == 7 and box_dim == 9:
            # 7-dim boxes: move yaw to the last slot, zero velocity
            boxes[:g, 8] = gb[:g, 6]
            boxes[:g, 6:8] = 0
        classes[:g] = np.asarray(annotations["labels"], np.int64)[:g]
        mask[:g] = True
    return {"gt_boxes": boxes, "gt_classes": classes, "gt_mask": mask}


def collate_fixed(samples: List, max_gt: int) -> Dict[str, Any]:
    """List of dataset items `(data, info)` → fixed-shape numpy batch.
    `data` must be the `PadPoints` output. efg_tpu's image batches and
    tracking fields are not ported yet."""
    first = samples[0][0]
    if not (isinstance(first, dict) and "points" in first):
        raise ValueError(
            "collate_fixed: the port batches PadPoints outputs only; end the "
            f"processors with PadPoints (got {type(first).__name__} "
            f"{list(first) if isinstance(first, dict) else ''})"
        )
    pts, msk, gtb, gtc, gtm = [], [], [], [], []
    for data, info in samples:
        pts.append(data["points"])
        msk.append(data["points_mask"])
        g = pad_gt(info.get("annotations"), max_gt)
        gtb.append(g["gt_boxes"])
        gtc.append(g["gt_classes"])
        gtm.append(g["gt_mask"])
    return {
        "points": np.stack(pts),
        "points_mask": np.stack(msk),
        "gt_boxes": np.stack(gtb),
        "gt_classes": np.stack(gtc),
        "gt_mask": np.stack(gtm),
        "metadata": [s[1].get("metadata", {}) for s in samples],
        "annotations": [s[1].get("annotations") for s in samples],
    }


class DataLoader:
    """Minimal prefetching loader over (dataset, sampler): batches of
    `batch_size` items, collated by `collate_fixed`."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        max_gt: int = 500,
        num_workers: int = 0,
        seed: Optional[int] = None,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        # Resume fast-forward: iterators skip the first `start_batch`
        # batches by discarding sampler indices (no item fetch, no
        # transform replay). With a seed set, augmentation RNG is derived
        # per item ORDINAL (see _seed_for), so the post-skip stream is
        # bit-identical to an uninterrupted run's.
        self.start_batch = 0

    def _seed_for(self, ordinal: int) -> int:
        """Deterministic per-item RNG stream: item k's augmentations draw
        from seed f(loader_seed, k) regardless of what ran before — the
        foundation for exact checkpoint-resume continuity and for
        order-independent multi-worker loading."""
        return (self.seed * 1_000_003 + ordinal * 7_368_787) % (2**31 - 1)

    def __len__(self) -> int:
        try:
            n = len(self.sampler)
        except TypeError:
            n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _fetch(self, idx: int, ordinal: int):
        # the processors draw from numpy's global RNG, one state for the
        # whole process: an item's seed and its draws happen under one
        # lock, or a worker thread's reseed (of this loader or of another)
        # lands between them (efg_tpu's loader has no such lock)
        with _GLOBAL_RNG_LOCK:
            if self.seed is not None:
                seed_all_rng(self._seed_for(ordinal))
            return self.dataset[idx]

    def _skipped_indices(self):
        """Fresh sampler iterator with the first start_batch batches of
        indices discarded; returns (iterator, first_ordinal)."""
        it = iter(self.sampler)
        n_skip = self.start_batch * self.batch_size
        for _ in range(n_skip):
            try:
                next(it)
            except StopIteration:
                break
        return it, n_skip

    def _iter_sequential(self) -> Iterator[Dict[str, Any]]:
        buf = []
        it, ordinal = self._skipped_indices()
        for idx in it:
            buf.append(self._fetch(idx, ordinal))
            ordinal += 1
            if len(buf) == self.batch_size:
                yield collate_fixed(buf, self.max_gt)
                buf = []
        if buf and not self.drop_last:
            while len(buf) < self.batch_size:  # repeat-pad the tail batch
                buf.append(buf[-1])
            yield collate_fixed(buf, self.max_gt)

    def _iter_threaded(self) -> Iterator[Dict[str, Any]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=4)
        idx_iter, base_ordinal = self._skipped_indices()
        counter = [base_ordinal]
        lock = threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                items = []
                with lock:
                    ordinal0 = counter[0]
                    try:
                        for _ in range(self.batch_size):
                            items.append(next(idx_iter))
                            counter[0] += 1
                    except StopIteration:
                        break
                if len(items) < self.batch_size:
                    break
                batch = collate_fixed(
                    [self._fetch(i, ordinal0 + k) for k, i in enumerate(items)],
                    self.max_gt,
                )
                while not stop.is_set():  # a closed iterator's worker stops here
                    try:
                        out_q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        pass
            out_q.put(None)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(1, self.num_workers))
        ]
        for t in threads:
            t.start()
        finished = 0
        try:
            while finished < len(threads):
                item = out_q.get()
                if item is None:
                    finished += 1
                    continue
                yield item
        finally:
            stop.set()

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.num_workers and self.num_workers > 0:
            return self._iter_threaded()
        return self._iter_sequential()


def build_dataloader(config, dataset, train: bool = True) -> DataLoader:
    """The train loader (an infinite shuffled stream, seeded from
    `misc.seed`) or the eval loader (one pass in order)."""
    dl = config.dataloader
    max_gt = int(config.dataset.get("max_gt", config.get("model", {}).get("loss", {}).get("max_objs", 500)))
    if train:
        sampler_name = dl.get("sampler", "DistributedInfiniteSampler")
        seed = config.misc.get("seed", -1)
        kw = dict(shuffle=True, seed=None if seed is None or seed < 0 else seed)
        sampler = SAMPLERS.get(sampler_name)(len(dataset), **kw)
        return DataLoader(
            dataset, sampler, int(dl.batch_size), max_gt=max_gt,
            num_workers=int(dl.get("num_workers", 0)),
            seed=None if seed is None or seed < 0 else seed,
        )
    sampler = SAMPLERS.get(dl.get("eval_sampler", "InferenceSampler"))(len(dataset))
    return DataLoader(
        dataset, sampler, int(dl.get("eval_batch_size", dl.batch_size)),
        max_gt=max_gt, num_workers=0, drop_last=False,
    )
