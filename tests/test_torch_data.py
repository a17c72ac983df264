"""Port parity: the synthetic 3D data path (efg_tpu_torch.data vs
efg_tpu.data). For the synthetic experiment's config and seed, the items,
each processor's output and the loaders' batches equal efg_tpu's bit for
bit; so do `pad_gt` / `collate_fixed` padding and the samplers' streams."""

import copy
from pathlib import Path

import numpy as np
import pytest

import efg_tpu.data as JD
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.data import builder as JB
from efg_tpu.data.processors import extend_3d as JE
from efg_tpu.data.samplers import dataset_sampler as JS
import efg_tpu_torch.data as TD
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data import builder as TB
from efg_tpu_torch.data.processors import extend_3d as TE
from efg_tpu_torch.data.samplers import dataset_sampler as TS

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.3d/synthetic/centerpoint.synth.voxelnet/config.yaml")
SMALL = ["trainer.evaluators=", "dataset.points_per_frame=2048",
         "dataset.processors.train[5].PadPoints.num_points=2048"]
N_BATCHES = 6


def _configs(opts=()):
    opts = SMALL + list(opts)
    return (JConfiguration(config_file=CONFIG, opts=list(opts)).get_config(),
            Configuration(config_file=CONFIG, opts=list(opts)).get_config())


def _equal(a, b, where=""):
    """Nested dicts / lists / arrays equal bit for bit (dtype and shape too)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("task", ["train", "val"])
def test_synthetic_items_equal(task):
    """Scenes and their processor chains, item by item, from one numpy seed."""
    jc, tc = _configs([f"task={task}"])
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    assert len(jds) == len(tds) == 64
    assert [repr(p) for p in jds.transforms] == [repr(p) for p in tds.transforms]
    for idx in (0, 1, 17, 63):
        np.random.seed(1000 + idx)
        want = jds[idx]
        np.random.seed(1000 + idx)
        got = tds[idx]
        _equal(want, got, f"item {idx}")
        raw_j, raw_t = jds._gen_scene(idx), tds._gen_scene(idx)
        _equal(list(raw_j), list(raw_t), f"scene {idx}")


PROCESSORS = {
    "PointShuffle": dict(p=0.5),
    "RandomFlip3D": dict(p=0.5),
    "GlobalRotation": dict(rotation=0.78539816),
    "GlobalScaling": dict(min_scale=0.95, max_scale=1.05),
    "FilterByRange": dict(pc_range=[-20.0, -20.0, -2.0, 20.0, 20.0, 4.0]),
    "PadPoints": dict(num_points=2048),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_outputs_equal(name):
    """Each processor on the same scene from the same numpy seed, over
    seeds that take both sides of every random branch; PadPoints both pads
    and subsamples."""
    jc, tc = _configs()
    ds = JD.build_dataset(jc)
    for seed in range(6):
        points, boxes, names = ds._gen_scene(seed)
        if name == "PadPoints" and seed % 2:
            points = points[:1500]
        info = {"annotations": {"gt_boxes": boxes, "gt_names": names,
                                "difficulty": np.ones(len(boxes), np.int8)},
                "sweeps": [{"annotations": {"gt_boxes": boxes.copy()}}]}
        jp = getattr(JE, name)(**PROCESSORS[name])
        tp = TD.PROCESSORS.get(name)(**PROCESSORS[name])
        assert type(tp).__module__ == TE.__name__
        np.random.seed(seed)
        want = jp(points.copy(), copy.deepcopy(info))
        state = np.random.get_state()
        np.random.seed(seed)
        got = tp(points.copy(), copy.deepcopy(info))
        _equal(list(want), list(got), f"{name} seed {seed}")
        # the same draws from the global RNG, so the next processor sees the same state
        assert np.random.get_state()[2] == state[2]
        np.testing.assert_array_equal(np.random.get_state()[1], state[1])


def _batches(loader, n=N_BATCHES):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def _loaders(workers=0, start_batch=0, opts=()):
    jc, tc = _configs([f"dataloader.num_workers={workers}", *opts])
    jl = JB.build_dataloader(jc, JD.build_dataset(jc))
    tl = TB.build_dataloader(tc, TD.build_dataset(tc))
    jl.start_batch = tl.start_batch = start_batch
    return jl, tl


def test_loader_batches_equal_from_start():
    jl, tl = _loaders()
    want, got = _batches(jl), _batches(tl)
    _equal(want, got, "batches")
    b = got[0]
    assert b["points"].shape == (2, 2048, 5) and b["gt_boxes"].shape == (2, 32, 9)
    assert b["gt_classes"].dtype == np.int32 and b["points_mask"].dtype == bool


def test_loader_start_batch_fast_forward():
    """A stream fast-forwarded by 3 batches is batches 3-5 of the
    uninterrupted stream, in both packages."""
    jl, tl = _loaders()
    full = _batches(tl)
    jl.start_batch = tl.start_batch = 3
    want, got = _batches(jl, 3), _batches(tl, 3)
    _equal(want, got, "fast-forwarded")
    _equal(full[3:], got, "against the uninterrupted stream")


def test_threaded_loader_batches_equal_per_ordinal():
    """Two worker threads: every batch equals efg_tpu's in-order batch of
    its ordinal. Batches arrive in the order they finish, so a batch may
    overtake an earlier one: each is matched among the next ones."""
    jl, _ = _loaders()
    want = _batches(jl, N_BATCHES + 6)
    for start in (0, 2):
        _, tl = _loaders(workers=2, start_batch=start)
        got = _batches(tl, N_BATCHES - start)
        unmatched = list(range(start, len(want)))
        for b in got:
            hit = [i for i in unmatched if np.array_equal(want[i]["points"], b["points"])]
            assert len(hit) == 1, f"a threaded batch matches batches {hit}"
            _equal(want[hit[0]], b, f"batch {hit[0]}")
            unmatched.remove(hit[0])


def test_pad_gt_and_collate_fixed():
    rs = np.random.RandomState(0)
    anno9 = {"gt_boxes": rs.randn(40, 9).astype(np.float32), "labels": rs.randint(1, 4, 40)}
    anno7 = {"gt_boxes": rs.randn(5, 7).astype(np.float64), "labels": np.arange(1, 6)}
    for anno in (anno9, anno7, None, {"gt_boxes": np.zeros((0, 9), np.float32),
                                      "labels": np.zeros(0, np.int64)}):
        _equal(JB.pad_gt(anno, 32), TB.pad_gt(anno, 32), "pad_gt")
    assert TB.pad_gt(anno7, 32)["gt_boxes"][4, 8] == np.float32(anno7["gt_boxes"][4, 6])
    samples = [({"points": rs.randn(16, 5).astype(np.float32), "points_mask": rs.rand(16) > 0.3},
                {"annotations": a, "metadata": {"token": str(i)}})
               for i, a in enumerate((anno9, anno7))]
    _equal(JB.collate_fixed(samples, 32), TB.collate_fixed(samples, 32), "collate_fixed")
    with pytest.raises(ValueError, match="PadPoints"):
        TB.collate_fixed([(rs.randn(4, 5), {})], 8)


@pytest.mark.parametrize("seed", [None, 0, 42])
def test_sampler_streams_equal(seed, monkeypatch):
    monkeypatch.setattr(JS, "_proc_info", lambda: (0, 1))
    for shuffle in (True, False):
        for j, t in ((JS.InfiniteSampler(64, shuffle=shuffle, seed=seed),
                      TS.InfiniteSampler(64, shuffle=shuffle, seed=seed)),
                     (JS.DistributedInfiniteSampler(10, shuffle=shuffle, seed=seed),
                      TS.DistributedInfiniteSampler(10, shuffle=shuffle, seed=seed)),
                     (JS.InfiniteSampler(10, seed=seed, rank=1, world_size=3),
                      TS.InfiniteSampler(10, seed=seed, rank=1, world_size=3))):
            ji, ti = iter(j), iter(t)
            assert [next(ji) for _ in range(150)] == [next(ti) for _ in range(150)]
    assert list(JS.InferenceSampler(13)) == list(TS.InferenceSampler(13)) == list(range(13))
