"""Dataset, processor and dataloader construction (port of
`efg_tpu/data/builder.py`).

The loader emits numpy batches of static shapes (padded points + masks,
padded GT arrays), as efg_tpu's does; `data/prefetcher.py` moves them to
the device. Training reads through worker threads when
`dataloader.num_workers` > 0, evaluation in order. With a seed, every
item's augmentations draw from a numpy seed derived from the item's
ordinal in the stream, so a stream fast-forwarded by `start_batch` or
read by several workers yields the same batches.

Under data parallelism the sampler gives every local rank of a machine
the machine's stream (efg_tpu's process's), and local rank l of L loads
only its slice of each batch: rows [l·n, (l+1)·n) with n = ⌈bs / L⌉. An
item keeps its ordinal in the machine's stream, so its draws do not
depend on the rank that loads it. A batch that does not split evenly (the
eval loader's) is padded by repeating its last item, as efg_tpu pads a
batch to its data axis; `local_valid` says how many of a rank's rows are
real.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from efg_tpu_torch.data.registry import DATASETS, PROCESSORS, SAMPLERS
from efg_tpu_torch.utils import distributed as comm
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
    `data` must be the `PadPoints` output. Items with detections (the
    tracking datasets) add `det_boxes` [B, max_gt, 9], `det_scores`,
    `det_labels` and `det_mask`, padded as the GT; items with trajectories
    (the motion pretrain) add `traj_hist`, `traj_mask`, `future_offsets`
    and `future_mask`, [B, max_gt, ...]. efg_tpu carries no `det_labels`
    (its `det_predict` labels a detection with the GT class of its slot);
    its image batches are not ported yet."""
    first = samples[0][0]
    if not (isinstance(first, dict) and "points" in first):
        raise ValueError(
            "collate_fixed: the port batches PadPoints outputs only; end the "
            f"processors with PadPoints (got {type(first).__name__} "
            f"{list(first) if isinstance(first, dict) else ''})"
        )
    pts, msk, gtb, gtc, gtm = [], [], [], [], []
    det = {"det_boxes": [], "det_scores": [], "det_labels": [], "det_mask": []}
    for data, info in samples:
        pts.append(data["points"])
        msk.append(data["points_mask"])
        anno = info.get("annotations")
        g = pad_gt(anno, max_gt)
        gtb.append(g["gt_boxes"])
        gtc.append(g["gt_classes"])
        gtm.append(g["gt_mask"])
        if anno is not None and "det_boxes" in anno:
            n = min(len(anno["det_boxes"]), max_gt)
            row = {"det_boxes": np.zeros((max_gt, 9), np.float32),
                   "det_scores": np.zeros((max_gt,), np.float32),
                   "det_labels": np.zeros((max_gt,), np.int32),
                   "det_mask": np.zeros((max_gt,), bool)}
            row["det_boxes"][:n] = anno["det_boxes"][:n]
            row["det_scores"][:n] = anno["det_scores"][:n]
            row["det_labels"][:n] = anno["det_labels"][:n]
            row["det_mask"][:n] = True
            for k, v in row.items():
                det[k].append(v)
    batch = {
        "points": np.stack(pts),
        "points_mask": np.stack(msk),
        "gt_boxes": np.stack(gtb),
        "gt_classes": np.stack(gtc),
        "gt_mask": np.stack(gtm),
    }
    if det["det_boxes"]:
        batch.update({k: np.stack(v) for k, v in det.items()})
    anno0 = samples[0][1].get("annotations") or {}
    if "traj_hist" in anno0:
        for key in ("traj_hist", "traj_mask", "future_offsets", "future_mask"):
            rows = []
            for _, info in samples:
                a = np.asarray(info["annotations"][key])
                pad = np.zeros((max_gt,) + a.shape[1:], a.dtype)
                pad[: min(len(a), max_gt)] = a[:max_gt]
                rows.append(pad)
            batch[key] = np.stack(rows)
    batch["metadata"] = [s[1].get("metadata", {}) for s in samples]
    batch["annotations"] = [s[1].get("annotations") for s in samples]
    return batch


class DataLoader:
    """Minimal prefetching loader over (dataset, sampler): batches of
    `batch_size` items, collated by `collate_fixed`; with `local_size` >
    1, local rank `local_rank`'s slice of each (`local_batch` rows, the
    first `local_valid` of them real)."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        max_gt: int = 500,
        num_workers: int = 0,
        seed: Optional[int] = None,
        drop_last: bool = True,
        local_rank: int = 0,
        local_size: int = 1,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.local_rank = local_rank
        self.local_size = local_size
        self.local_batch = -(-batch_size // local_size)
        self.local_valid = min(max(batch_size - local_rank * self.local_batch, 0),
                               self.local_batch)
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

    def _local_batch(self, idxs: List[int], ordinal0: int) -> Dict[str, Any]:
        """This rank's slice of the batch of sampler indices `idxs` (its
        first item at stream ordinal `ordinal0`), collated. The batch is
        padded with its last item to `batch_size` (a short tail batch) and
        to a multiple of the local ranks; each item is loaded once."""
        n = self.local_batch
        src = [min(p, len(idxs) - 1)
               for p in range(self.local_rank * n, (self.local_rank + 1) * n)]
        items: Dict[int, Any] = {}
        for k in src:
            if k not in items:
                items[k] = self._fetch(idxs[k], ordinal0 + k)
        return collate_fixed([items[k] for k in src], self.max_gt)

    def _iter_sequential(self) -> Iterator[Dict[str, Any]]:
        idxs: List[int] = []
        it, ordinal = self._skipped_indices()
        for idx in it:
            idxs.append(idx)
            if len(idxs) == self.batch_size:
                yield self._local_batch(idxs, ordinal)
                ordinal += len(idxs)
                idxs = []
        if idxs and not self.drop_last:
            yield self._local_batch(idxs, ordinal)

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
                batch = self._local_batch(items, ordinal0)
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
    `misc.seed`) or the eval loader (one pass in order), each yielding
    this local rank's slice of the machine's batches."""
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
            local_rank=comm.get_local_rank(), local_size=comm.get_local_size(),
        )
    name = dl.get("eval_sampler", "InferenceSampler")
    eval_bs = int(dl.get("eval_batch_size", dl.batch_size))
    if name == "SeqInferenceSampler":
        if eval_bs > 1 and comm.get_local_size() > 1:
            raise ValueError(
                f"SeqInferenceSampler with eval_batch_size={eval_bs} over "
                f"{comm.get_local_size()} local ranks would give each rank's tracker every "
                "other frame of a sequence; set dataloader.eval_batch_size=1 (local rank 0 "
                "then reads every frame of the machine's sequences)")
        # a deviation: efg_tpu builds it from len(dataset) alone, so every
        # frame falls in one sequence and its first process takes them all
        sampler = SAMPLERS.get(name)(len(dataset), getattr(dataset, "sequence_ids", None))
    else:
        sampler = SAMPLERS.get(name)(len(dataset))
    return DataLoader(
        dataset, sampler, eval_bs, max_gt=max_gt, num_workers=0, drop_last=False,
        local_rank=comm.get_local_rank(), local_size=comm.get_local_size(),
    )
