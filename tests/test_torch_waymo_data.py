"""Port parity: the flagship's host side (efg_tpu_torch vs efg_tpu, numpy
paths on both sides: efg_tpu's native library is not built here).

Box geometry and host voxelization on seeded and degenerate boxes; the
TFRecord decoder on a record written by efg_tpu's encoder; `create_data`'s
infos and GT-crop database on the same frame pickles; every processor of
`extend_3d.py` from the same numpy seed; `WaymoDetectionDataset` items at
1 and 4 sweeps; the GT-database sampler's stateful crop stream; the
flagship pipeline's loader batches from the start and after a resume; and
the stated deviation of the sampler under two local ranks."""

import copy
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import yaml

import efg_tpu.data as JD
from efg_tpu import native as jnative
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.data import builder as JB
from efg_tpu.data.processors import extend_3d as JE
from efg_tpu.data.samplers.gt_database_sampler import DataBaseSampler as JDataBaseSampler
from efg_tpu.geometry import box_ops_np as JG
from efg_tpu.ops import voxelize_np as JV
import efg_tpu_torch.data as TD
from efg_tpu_torch.cli.data_preparation.waymo import create_data as TC
from efg_tpu_torch.cli.data_preparation.waymo import tfrecord_decoder as TDEC
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data import builder as TB
from efg_tpu_torch.data.processors import extend_3d as TE
from efg_tpu_torch.data.samplers.gt_database_sampler import DataBaseSampler as TDataBaseSampler
from efg_tpu_torch.geometry import box_ops_np as TG
from efg_tpu_torch.ops import voxelize_np as TV

from test_torch_data import _equal

ROOT = Path(__file__).resolve().parents[1]
WAYMO = "playground/detection.3d/waymo/center_point"
FLAGSHIP_EXP = "centerpoint.waymo.voxelnet.gt_aug.onecycle.adamw.bs48.36e"
FOURF_EXP = "centerpoint.waymo.voxelnet.4f.36e"
EXTENT = 11.0  # the fixture frames' half-width (m)
PC_RANGE = [-12.8, -12.8, -2.0, 12.8, 12.8, 4.0]
N_POINTS = 1500
# (label, count a frame, dims): the decoder's labels; SIGN is not a class
OBJECTS = ((1, 3, (4.5, 2.0, 1.6)), (2, 2, (0.9, 0.8, 1.7)), (4, 2, (1.8, 0.7, 1.6)),
           (3, 1, (0.5, 0.5, 1.0)))
SAMPLE_GROUPS = [{"VEHICLE": 15}, {"PEDESTRIAN": 10}, {"CYCLIST": 10}]


def test_native_library_is_not_built():
    """efg_tpu runs its numpy paths here, which are the ones the port copies."""
    assert not jnative.available()


# ------------------------------------------------------------ box geometry

def _boxes(seed, n=12, extent=6.0, vel=True):
    rs = np.random.RandomState(seed)
    b = np.zeros((n, 9 if vel else 7))
    b[:, :2] = rs.uniform(-extent, extent, (n, 2))
    b[:, 2] = rs.uniform(-1, 1, n)
    b[:, 3:6] = rs.uniform(0.5, 4.0, (n, 3))
    if vel:
        b[:, 6:8] = rs.randn(n, 2)
    b[:, -1] = rs.uniform(-np.pi, np.pi, n)
    return b


def _square(cx, cy, size, yaw=0.0):
    return np.array([cx, cy, 0.0, size, size, 1.0, yaw])


# touching edges, one box inside another, a zero-area box, identical boxes
COLLISION_CASES = {
    "seeded": lambda: (_boxes(0, 16, 4.0, vel=False), _boxes(1, 10, 4.0, vel=False)),
    "touching": lambda: (np.stack([_square(0, 0, 2)]), np.stack([_square(2, 0, 2), _square(0, 2, 2),
                                                                  _square(2.0001, 0, 2)])),
    "nested": lambda: (np.stack([_square(0, 0, 4)]), np.stack([_square(0.3, -0.2, 1, 0.7)])),
    "degenerate": lambda: (np.stack([_square(0, 0, 0.0), _square(5, 5, 2)]),
                           np.stack([_square(0, 0, 2), _square(5, 5, 0.0, 0.3)])),
    "identical": lambda: (np.stack([_square(1, 1, 2, 0.4)] * 2), np.stack([_square(1, 1, 2, 0.4)])),
}


@pytest.mark.parametrize("case", sorted(COLLISION_CASES))
def test_box_collision_test_matches(case):
    a, b = COLLISION_CASES[case]()
    ca, cb = JG.boxes_to_corners_bev(a), JG.boxes_to_corners_bev(b)
    np.testing.assert_allclose(TG.boxes_to_corners_bev(a), ca, rtol=0, atol=1e-6)
    np.testing.assert_allclose(TG.corner_to_standup(ca), JG.corner_to_standup(ca), rtol=0, atol=1e-6)
    want = JG.box_collision_test(ca, cb)
    got = TG.box_collision_test(ca, cb)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TG.box_collision_test(ca, ca), JG.box_collision_test(ca, ca))
    if case == "nested":
        assert want.all()


def test_box_ops_match():
    """Every ported `box_ops_np` function on seeded boxes: floats at 1e-6,
    booleans bit for bit."""
    rs = np.random.RandomState(3)
    boxes = _boxes(2, 20, 8.0)
    pts = rs.uniform(-9, 9, (400, 5))
    rng = [-5.0, -4.0, -0.5, 6.0, 5.0, 0.5]
    ang = rs.uniform(-10, 10, 50)
    for off, per in ((0.5, np.pi), (0.0, 2 * np.pi)):
        np.testing.assert_allclose(TG.limit_period(ang, off, per), JG.limit_period(ang, off, per),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(TG.boxes_to_corners_3d(boxes), JG.boxes_to_corners_3d(boxes),
                               rtol=0, atol=1e-6)
    for margin in (0.0, 0.3):
        np.testing.assert_array_equal(TG.points_in_rbbox(pts, boxes, margin),
                                      JG.points_in_rbbox(pts, boxes, margin))
    for fn in ("mask_points_by_range", "mask_points_by_range_bev"):
        np.testing.assert_array_equal(getattr(TG, fn)(pts, rng), getattr(JG, fn)(pts, rng))
    for fn in ("mask_boxes_outside_range_center", "mask_boxes_outside_range",
               "mask_boxes_outside_range_bev_z_bound"):
        np.testing.assert_array_equal(getattr(TG, fn)(boxes, rng), getattr(JG, fn)(boxes, rng))
    np.testing.assert_array_equal(TG.mask_boxes_outside_range(boxes, rng, 4),
                                  JG.mask_boxes_outside_range(boxes, rng, 4))
    for size in ((3.0, 1.5), (0.4, 0.9), (10.0, 2.0)):
        for ov in (0.1, 0.5, 0.7):
            assert abs(TG.gaussian_radius(size, ov) - JG.gaussian_radius(size, ov)) <= 1e-6
    assert TG.points_in_rbbox(pts, boxes[:0]).shape == (400, 0)


@pytest.mark.parametrize("max_points,max_voxels", [(5, 20000), (2, 60)])
def test_points_to_voxel_bit_equal(max_points, max_voxels):
    """Host voxelization bit for bit, with voxels and points per voxel cut."""
    rs = np.random.RandomState(5)
    pts = np.concatenate([rs.uniform(-3, 3, (2000, 3)), rs.uniform(0, 1, (2000, 2))], 1)
    pts = np.concatenate([pts, pts[:300] + 0.01]).astype(np.float32)  # shared voxels
    args = ([0.5, 0.5, 0.5], [-2.0, -2.0, -2.0, 2.0, 2.0, 2.0], max_points, max_voxels)
    want, got = JV.points_to_voxel(pts, *args), TV.points_to_voxel(pts, *args)
    _equal(list(want), list(got), "points_to_voxel")
    gen = dict(voxel_size=args[0], point_cloud_range=args[1], max_num_points=max_points,
               max_voxels=max_voxels)
    _equal(list(JV.VoxelGenerator(**gen).generate(pts)), list(TV.VoxelGenerator(**gen).generate(pts)))


# ------------------------------------------------------- data preparation

def test_tfrecord_decoder_pickles_equal(tmp_path):
    """A record written by efg_tpu's encoder (the frame of
    tests/test_tfrecord_decoder.py, twice) decodes to equal pickles."""
    import test_tfrecord_decoder as JT

    frames = [JT.make_frame(np.random.RandomState(s))[0] for s in (0, 1)]
    rec = str(tmp_path / "seq.tfrecord")
    JT.TD.write_tfrecord(rec, frames)
    assert list(TDEC.read_tfrecord(rec)) == frames
    out = {}
    for name, mod in (("jax", JT.TD), ("torch", TDEC)):
        lidar, annos = (tmp_path / name / "lidar"), (tmp_path / name / "annos")
        lidar.mkdir(parents=True)
        annos.mkdir(parents=True)
        assert mod.convert_record(rec, 3, str(lidar), str(annos)) == 2
        out[name] = {f"{d.name}/{f}": pickle.loads((d / f).read_bytes())
                     for d in (lidar, annos) for f in sorted(os.listdir(d))}
    assert sorted(out["torch"]) == [f"{d}/seq_3_frame_{i}.pkl" for d in ("annos", "lidar")
                                    for i in (0, 1)]
    _equal(out["jax"], out["torch"], "pickles")
    TDEC.write_tfrecord(str(tmp_path / "again.tfrecord"), frames)
    assert (tmp_path / "again.tfrecord").read_bytes() == Path(rec).read_bytes()


def write_waymo_frames(root, split, n_seq, n_frames, seed, n_points=N_POINTS, extent=EXTENT):
    """Frame and anno pickles in the decoder's schema: `n_seq` sequences
    of `n_frames` frames (poses advancing along the sequence), each with
    OBJECTS' boxes and points inside every box over a ground cloud."""
    for d in ("lidar", "annos"):
        os.makedirs(os.path.join(root, split, d), exist_ok=True)
    for s in range(n_seq):
        for f in range(n_frames):
            rs = np.random.RandomState(seed * 1000 + s * 100 + f)
            objects, clusters = [], []
            for label, count, dims in OBJECTS:
                for _ in range(count):
                    d = np.abs(np.asarray(dims) + rs.randn(3) * 0.1)
                    box = np.zeros(9, np.float32)
                    box[:2] = rs.uniform(-0.8 * extent, 0.8 * extent, 2)
                    box[2] = rs.uniform(-0.5, 1.0)
                    box[3:6] = d
                    box[6:8] = rs.randn(2)
                    box[8] = rs.uniform(-np.pi, np.pi)
                    n_in = int(rs.randint(6, 40))
                    local = rs.uniform(-0.45, 0.45, (n_in, 3)) * d
                    c, sn = np.cos(box[8]), np.sin(box[8])
                    clusters.append(np.stack([local[:, 0] * c - local[:, 1] * sn + box[0],
                                              local[:, 0] * sn + local[:, 1] * c + box[1],
                                              local[:, 2] + box[2]], 1))
                    diff = int(rs.randint(0, 3))
                    objects.append({
                        "id": len(objects), "name": f"obj-{s}-{len(objects)}", "label": label,
                        "box": box, "num_points": n_in, "detection_difficulty_level": diff,
                        "combined_difficulty_level": diff or (1 if n_in >= 5 else 2),
                        "global_speed": box[6:8].copy(), "global_accel": np.zeros(2, np.float32)})
            n_bg = n_points - sum(len(c) for c in clusters)
            bg = np.stack([rs.uniform(-extent, extent, n_bg), rs.uniform(-extent, extent, n_bg),
                           rs.uniform(-1.8, -1.2, n_bg)], 1)
            xyz = np.concatenate([bg] + clusters).astype(np.float32)
            feat = np.stack([rs.uniform(0, 3, len(xyz)), rs.uniform(0, 1, len(xyz))], 1)
            yaw = 0.3 * s + 0.05 * f
            pose = np.eye(4)
            pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
            pose[:3, 3] = [100.0 * s + 1.5 * f, 0.4 * f, 0.02 * f]
            name = f"seq_{s}_frame_{f}.pkl"
            head = {"scene_name": f"{split}{s}", "frame_name": f"{split}{s}_{f}", "frame_id": f}
            with open(os.path.join(root, split, "lidar", name), "wb") as fh:
                pickle.dump({**head, "lidars": {"points_xyz": xyz,
                                                "points_feature": feat.astype(np.float32)}}, fh)
            with open(os.path.join(root, split, "annos", name), "wb") as fh:
                pickle.dump({**head, "veh_to_global": pose.reshape(-1), "objects": objects}, fh)


def prepare_waymo(root, create_data=TC, n_train_seq=2, n_frames=4, n_val=4):
    """The fixture dataset through `create_data`: frames, infos at 1 and 4
    sweeps of both splits and the train split's GT database."""
    write_waymo_frames(root, "train", n_train_seq, n_frames, seed=1)
    write_waymo_frames(root, "val", 1, n_val, seed=2)
    for split in ("train", "val"):
        for nsweeps in (1, 4):
            infos = create_data.build_infos(root, split, nsweeps)
            with open(os.path.join(root, f"infos_{split}_{nsweeps:02d}sweeps_sampled.pkl"), "wb") as fh:
                pickle.dump(infos, fh)
            if split == "train" and nsweeps == 1:
                create_data.build_gt_database(
                    root, infos, "gt_database_train_01sweeps_withvelo_sampled")


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    prepare_waymo(root)
    return root


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = open(os.path.join(d, n), "rb").read()
    return out


def test_create_data_matches(waymo_root, tmp_path):
    """efg_tpu's create_data on the same frames: infos equal, the GT
    database's infos equal and every `.bin` crop equal byte for byte."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "efg_tpu_waymo_create_data", ROOT / "cli" / "data_preparation" / "waymo" / "create_data.py")
    JC = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(JC)
    root = str(tmp_path)
    prepare_waymo(root, create_data=JC)
    want, got = _files(root), _files(waymo_root)
    assert sorted(want) == sorted(got)
    crops = [k for k in got if k.endswith(".bin")]
    assert {k.split(os.sep)[1].rsplit("_", 1)[0] for k in crops} == {"VEHICLE", "PEDESTRIAN",
                                                                     "CYCLIST"}
    for k in crops:
        assert want[k] == got[k], k
    for k in got:
        if k.endswith(".pkl") and not k.startswith(("train", "val")):
            _equal(pickle.loads(want[k]), pickle.loads(got[k]), k)
    infos = pickle.loads(got["infos_train_04sweeps_sampled.pkl"])
    assert [len(i["sweeps"]) for i in infos] == [0, 1, 2, 3] * 2


# ------------------------------------------------- configs, items, loader

def waymo_config_file(out_root, data_root, exp=FLAGSHIP_EXP, *, nsweeps=None, sampling=True):
    """The experiment's config.yaml with its `dataset.source` written out
    (the Waymo configs do not resolve as written in either package) and cut
    to the tests' size, at `<out_root>/playground/<its path>/config.yaml`
    so the port's CLI finds the experiment's net.py."""
    with open(ROOT / WAYMO / exp / "config.yaml") as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    ns = nsweeps or cfg["dataset"]["nsweeps"]
    d = cfg["dataset"]
    d["source"] = {"root": data_root, "train": f"/infos_train_{ns:02d}sweeps_sampled.pkl",
                   "val": f"/infos_val_{ns:02d}sweeps_sampled.pkl",
                   "test": f"/infos_val_{ns:02d}sweeps_sampled.pkl",
                   "gt_database": "/gt_database_train_01sweeps_withvelo_sampled_infos"}
    d["pc_range"] = PC_RANGE
    for split in ("train", "val"):
        d["processors"][split][-1]["PadPoints"]["num_points"] = 2048
    if not sampling:
        assert "DatabaseSampling" in d["processors"]["train"].pop(0)
    cfg["dataloader"] = {"num_workers": 0, "batch_size": 2}
    m = cfg["model"]
    m.update(max_voxels=2048, stage_caps=[2048, 2048, 1024, 1024])
    m["neck"].update(layer_nums=[1, 1], ds_num_filters=[32, 64], us_num_filters=[32, 32])
    m["post_process"]["nms"].update(nms_pre_max_size=256, nms_post_max_size=100)
    cfg["trainer"].update(log_interval=1, window_size=1)
    cfg["misc"] = {"seed": 42}  # the config's -1 draws a seed at random
    path = Path(out_root) / WAYMO / exp / "config.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def config_file(waymo_root, tmp_path_factory):
    return waymo_config_file(str(tmp_path_factory.mktemp("exp")), waymo_root)


def _configs(path, opts=()):
    return (JConfiguration(config_file=path, opts=list(opts)).get_config(),
            Configuration(config_file=path, opts=list(opts)).get_config())


def _datasets(path, opts=(), seed=0):
    """Both packages' datasets, each built after seeding numpy as the CLI
    does (the GT-database sampler shuffles its crops when it is built)."""
    jc, tc = _configs(path, opts)
    np.random.seed(seed)
    jds = JD.build_dataset(jc)
    np.random.seed(seed)
    tds = TD.build_dataset(tc)
    return jc, tc, jds, tds


def test_flagship_config_resolves(config_file):
    jc, tc = _configs(config_file)
    assert tc.dataset.processors.train[0].DatabaseSampling.db_info_path == \
        jc.dataset.processors.train[0].DatabaseSampling.db_info_path
    assert tc.dataset.processors.train[0].DatabaseSampling.db_info_path.endswith(
        "/gt_database_train_01sweeps_withvelo_sampled_infos.pkl")


@pytest.mark.parametrize("nsweeps,task", [(1, "train"), (4, "val"), (4, "train")])
def test_items_equal(waymo_root, tmp_path, monkeypatch, nsweeps, task):
    """Items of the flagship (1 sweep) and 4f (4 sweeps, pose-chained, a
    time-lag channel) experiments, item by item from one numpy seed. The 4f
    train pipeline's GT database is the 1-sweep one (5 columns) read as 6
    columns, as in efg_tpu, so its train items run without DatabaseSampling
    here (`test_4f_database_width`). Sweep paths are relative to the
    working directory in both packages (`create_data` writes them relative
    to the root, and the dataset joins only the frame's own path)."""
    monkeypatch.chdir(waymo_root)
    exp = FLAGSHIP_EXP if nsweeps == 1 else FOURF_EXP
    path = waymo_config_file(str(tmp_path), waymo_root, exp, nsweeps=nsweeps,
                             sampling=nsweeps == 1)
    jc, tc, jds, tds = _datasets(path, [f"task={task}"])
    assert len(jds) == len(tds)
    assert [repr(p) for p in jds.transforms] == [repr(p) for p in tds.transforms]
    idxs = [i for i in range(len(tds)) if len(tds.dataset_dicts[i]["sweeps"]) >= nsweeps - 1]
    assert idxs
    for idx in idxs:
        np.random.seed(100 + idx)
        want = jds[idx]
        np.random.seed(100 + idx)
        got = tds[idx]
        _equal(want, got, f"item {idx}")
        pts = got[0]["points"]
        assert pts.shape[1] == (5 if nsweeps == 1 else 6)
        if nsweeps == 4:
            lags = np.unique(pts[got[0]["points_mask"], 5])
            np.testing.assert_allclose(lags, [0.0, 0.1, 0.2, 0.3], rtol=1e-6)


def test_4f_database_width(waymo_root):
    """The 4f config samples from the 1-sweep GT database (5 columns) with
    `num_point_features` 6: both packages read the crops as 6 columns, and
    both refuse a crop whose float count is not a multiple of 6."""
    db = os.path.join(waymo_root, "gt_database_train_01sweeps_withvelo_sampled_infos.pkl")
    boxes = np.zeros((0, 9), np.float32)
    names = np.zeros((0,), "<U10")
    out = []
    for cls in (JDataBaseSampler, TDataBaseSampler):
        np.random.seed(0)
        s = cls(db, SAMPLE_GROUPS, min_points=5)
        np.random.seed(1)
        try:
            out.append(("ok", s.sample_all(waymo_root, boxes, names, 6)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0][0] == out[1][0]
    _equal(out[0][1], out[1][1], "4f crops")


def _db(waymo_root):
    return os.path.join(waymo_root, "gt_database_train_01sweeps_withvelo_sampled_infos.pkl")


def test_database_sampler_stream_equal(waymo_root, config_file):
    """DataBaseSampler's crops over a stream of 6 items: the same crops in
    the same order, its cyclic position and reshuffles carried from item
    to item (each item seeded as the loader seeds it)."""
    tc = Configuration(config_file=config_file, opts=["task=train"]).get_config()
    np.random.seed(7)
    ds = TD.build_dataset(tc)
    samplers = []
    for cls in (JDataBaseSampler, TDataBaseSampler):
        np.random.seed(0)
        samplers.append(cls(_db(waymo_root), SAMPLE_GROUPS, min_points=5))
    j, t = samplers
    assert [len(v) for v in t._group_db_infos.values()] == \
        [len(v) for v in j._group_db_infos.values()]
    for k in range(6):
        info = copy.deepcopy(ds.dataset_dicts[k % len(ds)])
        keep = np.isin(info["gt_names"], ["VEHICLE", "PEDESTRIAN", "CYCLIST"])
        boxes, names = info["gt_boxes"][keep], info["gt_names"][keep]
        res = []
        for s in samplers:
            np.random.seed(1000 + k)
            res.append(s.sample_all(waymo_root, boxes, names, 5))
        _equal(res[0], res[1], f"item {k}")
        assert res[1] is not None and len(res[1]["gt_boxes"])
    for name, b in t._sampler_dict.items():
        assert b._indices == j._sampler_dict[name]._indices and b._idx == j._sampler_dict[name]._idx


def _processor_kwargs(db):
    crop = [-10.0, -10.0, -2.0, 10.0, 10.0, 4.0]
    return {
        "FilterByDifficulty": dict(filter_difficulties=[2]),
        "DatabaseSampling": dict(db_info_path=db, sample_groups=SAMPLE_GROUPS, min_points=5,
                                 difficulty=-1, rm_points_after_sample=True),
        "PointShuffle": dict(p=0.5),
        "RandomFlip3D": dict(p=0.5),
        "GlobalRotation": dict(rotation=0.78539816),
        "GlobalScaling": dict(min_scale=0.95, max_scale=1.05),
        "GlobalTranslation": dict(std=[0.2, 0.2, 0.1]),
        "PointsJitter": dict(jitter_std=[0.02, 0.02, 0.02], clip_range=[-0.03, 0.03]),
        "PointDrop": dict(p=0.2),
        "FilterByRange": dict(pc_range=[-6.0, -7.0, -1.6, 8.0, 5.0, 4.0]),
        "FilterByRangeCenter": dict(pc_range=[-6.0, -7.0, -1.6, 8.0, 5.0, 4.0]),
        "FilterByRangeXY": dict(pc_range=[-6.0, -7.0, -1.6, 8.0, 5.0, 4.0]),
        "GTDrop": dict(ratio=[0.0, 0.6]),
        "GTDropByCat": dict(ratio=[0.0, [0.3, 0.6, 0.9]],
                            categories=["VEHICLE", "PEDESTRIAN", "CYCLIST"]),
        "RandomCropPoints": dict(crop_type="relative_range", crop_size=[0.5], pc_range=crop, p=0.8),
        "Voxelization": dict(pc_range=PC_RANGE, voxel_size=[0.4, 0.4, 0.5],
                             max_points_in_voxel=4, max_voxel_num=600),
        "PadPoints": dict(num_points=1400),
    }


def test_every_processor_is_ported():
    assert sorted(_processor_kwargs("")) == sorted(
        n for n, c in vars(JE).items() if isinstance(c, type) and c.__module__ == JE.__name__
        and n != "_FilterBase") == sorted(
        n for n, c in vars(TE).items() if isinstance(c, type) and c.__module__ == TE.__name__
        and n != "_FilterBase")


@pytest.mark.parametrize("name", sorted(_processor_kwargs("")))
def test_processor_outputs_equal(name, waymo_root, config_file):
    """Each of the 17 processors on the same frame from the same numpy
    seed, over seeds that take both sides of the random branches; the
    numpy RNG state after it is the same too."""
    tc = Configuration(config_file=config_file, opts=["task=train"]).get_config()
    tc.dataset.processors.train = []
    ds = TD.build_dataset(tc)
    kw = _processor_kwargs(_db(waymo_root))[name]
    np.random.seed(0)
    jp = getattr(JE, name)(**kw)
    np.random.seed(0)
    tp = TD.PROCESSORS.get(name)(**kw)
    assert type(tp).__module__ == TE.__name__
    for seed in range(4):
        np.random.seed(seed)
        points, info = ds[seed % len(ds)]
        info["sweeps"] = [{"annotations": copy.deepcopy(info["annotations"])}]
        np.random.seed(seed)
        want = jp(points.copy(), copy.deepcopy(info))
        state = np.random.get_state()
        np.random.seed(seed)
        got = tp(points.copy(), copy.deepcopy(info))
        _equal(list(want), list(got), f"{name} seed {seed}")
        assert np.random.get_state()[2] == state[2]
        np.testing.assert_array_equal(np.random.get_state()[1], state[1])


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def _loaders(path, opts=(), start_batch=0):
    jc, tc, jds, tds = _datasets(path, ["task=train", *opts])
    jl, tl = JB.build_dataloader(jc, jds), TB.build_dataloader(tc, tds)
    jl.start_batch = tl.start_batch = start_batch
    return jl, tl


def test_flagship_loader_batches_equal(config_file):
    """The flagship train pipeline (DatabaseSampling first) through both
    loaders at num_workers 0: the first 3 batches bit for bit, GT pasted."""
    jl, tl = _loaders(config_file)
    want, got = _batches(jl, 3), _batches(tl, 3)
    _equal(want, got, "batches")
    b = got[0]
    assert b["points"].shape == (2, 2048, 5) and b["gt_boxes"].shape == (2, 500, 9)
    assert (b["gt_mask"].sum(1) > 7).all()  # more than a fixture frame's 7 class boxes


def test_resume_draws_other_crops_in_both(config_file):
    """A resumed run builds a fresh GT-database sampler: its batch 2
    differs from the uninterrupted run's in efg_tpu, and the port's resumed
    batch equals efg_tpu's resumed batch."""
    jl, _ = _loaders(config_file)
    uninterrupted = _batches(jl, 3)[2]
    jl, tl = _loaders(config_file, start_batch=2)
    want, got = _batches(jl, 1)[0], _batches(tl, 1)[0]
    _equal(want, got, "resumed batch")
    assert not np.array_equal(want["gt_boxes"], uninterrupted["gt_boxes"])


def test_two_local_ranks_sample_their_own_rows(config_file, monkeypatch):
    """The stated deviation under data parallelism: local rank l loads
    only its rows of each machine batch, so its GT-database sampler
    advances over those rows alone. Each rank's items equal one process
    that loads only that rank's ordinals; rank 0's first item equals the
    one-process stream's, rank 1's does not."""
    one = _loaders(config_file)[1]
    stream = []
    it = iter(one.sampler)
    for ordinal in range(4):
        stream.append(one._fetch(next(it), ordinal))
    for rank in (0, 1):
        jc, tc, _, tds = _datasets(config_file, ["task=train"])
        tl = TB.DataLoader(tds, copy.deepcopy(one.sampler), batch_size=2, max_gt=500, seed=one.seed,
                           local_rank=rank, local_size=2)
        got = _batches(tl, 2)
        _, _, _, alone = _datasets(config_file, ["task=train"])
        solo = TB.DataLoader(alone, None, 2, seed=one.seed)
        idx = iter(copy.deepcopy(one.sampler))
        idxs = [next(idx) for _ in range(4)]
        for b, batch in enumerate(got):
            ordinal = 2 * b + rank
            item = solo._fetch(idxs[ordinal], ordinal)
            want = TB.collate_fixed([item], 500)
            _equal({k: v for k, v in want.items() if k != "metadata"},
                   {k: v for k, v in batch.items() if k != "metadata"}, f"rank {rank} batch {b}")
        first = TB.collate_fixed([stream[rank]], 500)
        same = np.array_equal(first["gt_boxes"], got[0]["gt_boxes"])
        assert same == (rank == 0)
