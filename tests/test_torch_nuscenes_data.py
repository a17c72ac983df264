"""Port parity: the nuScenes host side (efg_tpu_torch vs efg_tpu) on fixture
files written here in nuScenes' on-disk format (the v1.0 JSON tables,
`samples/` and `sweeps/` `.bin` files of 5 float32 columns, 3 sweeps before
every key frame): `create_data`'s info pickles field by field and
`nuscenes2kitti`'s files byte for byte; `nuScenesDetectionDataset` items
and its CBGS resampling from the same numpy seed; the port's three stated
deviations (category names mapped to the detection classes, boxes turned
into the EFG frame with the points, val items labelled);
`nuScenesDetEvaluator`'s results on seeded predictions."""

import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import efg_tpu.data as JD
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.data import builder as JB
from efg_tpu.evaluator.nuscenes_evaluator import nuScenesDetEvaluator as JEvaluator
import efg_tpu_torch.data as TD
from efg_tpu_torch.cli.data_preparation.nuscenes import create_data as TC
from efg_tpu_torch.cli.data_preparation.nuscenes import nuscenes2kitti as TK
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data import builder as TB
from efg_tpu_torch.data.datasets.nuscenes import GENERAL_TO_DETECTION, to_efg_frame
from efg_tpu_torch.evaluator.nuscenes_evaluator import nuScenesDetEvaluator as TEvaluator

from test_torch_data import _equal

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # efg_tpu's data preparation lives in cli/
from cli.data_preparation.nuscenes import create_data as JC  # noqa: E402
from cli.data_preparation.nuscenes import nuscenes2kitti as JK  # noqa: E402

NUSC = "playground/detection.3d/nuscenes/centerpoint"
PILLAR_EXP = "centerpoint.pillar.nusc_mini.1sweep"
VOXEL_EXP = "centerpoint.nusc.voxelnet.cbgs.20e"
VERSION = "v1.0-mini"
CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
           "bicycle", "pedestrian", "traffic_cone"]
# (category, attribute, size w, l, h): every detection class, one class
# without attributes (barrier, cone), one the map sends to "ignore"
OBJECTS = (("vehicle.car", "vehicle.moving", (1.9, 4.5, 1.6)),
           ("vehicle.car", "vehicle.parked", (1.8, 4.2, 1.5)),
           ("vehicle.truck", "vehicle.stopped", (2.5, 7.0, 3.0)),
           ("vehicle.construction", "vehicle.parked", (2.8, 6.5, 3.2)),
           ("vehicle.bus.rigid", "vehicle.moving", (2.9, 11.0, 3.4)),
           ("vehicle.trailer", "vehicle.parked", (2.3, 9.0, 3.5)),
           ("movable_object.barrier", None, (2.0, 0.5, 1.0)),
           ("vehicle.motorcycle", "cycle.with_rider", (0.8, 2.1, 1.5)),
           ("vehicle.bicycle", "cycle.without_rider", (0.6, 1.7, 1.3)),
           ("human.pedestrian.adult", "pedestrian.moving", (0.7, 0.7, 1.8)),
           ("movable_object.trafficcone", None, (0.4, 0.4, 1.0)),
           ("animal", None, (0.5, 1.0, 0.6)))


def _quat_yaw(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def write_nuscenes(root, n_scenes=2, n_keys=3, n_sweeps=3, n_points=400, extent=12.0, seed=0,
                   version=VERSION):
    """nuScenes tables and LiDAR files: per scene `n_keys` key frames 0.5 s
    apart, each preceded by `n_sweeps` sweeps 0.05 s apart on one chain of
    LIDAR_TOP sample_data; OBJECTS' instances moving through the scene's
    key frames (prev / next annotation links, attributes); lidarseg labels
    for the key frames. Returns the version."""
    rs = np.random.RandomState(seed)
    tabs = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
                            "sample_annotation", "instance", "category", "attribute",
                            "lidarseg")}
    cats = sorted({c for c, _, _ in OBJECTS})
    attrs = sorted({a for _, a, _ in OBJECTS if a})
    tabs["category"] = [dict(token=f"cat{i}", name=n) for i, n in enumerate(cats)]
    tabs["attribute"] = [dict(token=f"attr{i}", name=n) for i, n in enumerate(attrs)]
    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP", "lidarseg", version):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    t0 = 1_500_000_000_000_000
    for s in range(n_scenes):
        keys = [f"s{s}_{k}" for k in range(n_keys)]
        tabs["scene"].append(dict(token=f"sc{s}", name=f"scene-{s + 1:04d}",
                                  first_sample_token=keys[0], last_sample_token=keys[-1]))
        insts = []
        for o, (cat, attr, size) in enumerate(OBJECTS):
            tok = f"in{s}_{o}"
            tabs["instance"].append(dict(token=tok, category_token=f"cat{cats.index(cat)}"))
            start = rs.uniform(-0.7 * extent, 0.7 * extent, 2)
            insts.append((tok, attr, size, start, rs.uniform(-2, 2, 2), rs.uniform(-np.pi, np.pi)))
        chain = []  # (token, sample token, key?, timestamp)
        for k, key in enumerate(keys):
            tk = t0 + s * 100_000_000 + k * 500_000
            chain += [(f"sd{s}_{k}_{j}", key, False, tk - (n_sweeps - j) * 50_000)
                      for j in range(n_sweeps)]
            chain.append((f"sd{s}_{k}_key", key, True, tk))
            tabs["sample"].append(dict(
                token=key, scene_token=f"sc{s}", timestamp=tk,
                prev=keys[k - 1] if k else "", next=keys[k + 1] if k + 1 < n_keys else "",
                anns=[f"a{s}_{k}_{o}" for o in range(len(OBJECTS))]))
            for o, (tok, attr, size, start, vel, yaw) in enumerate(insts):
                xy = start + vel * 0.5 * k
                tabs["sample_annotation"].append(dict(
                    token=f"a{s}_{k}_{o}", sample_token=key, instance_token=tok,
                    translation=[float(xy[0]), float(xy[1]), 0.8], size=list(size),
                    rotation=_quat_yaw(yaw + 0.05 * k),
                    prev=f"a{s}_{k - 1}_{o}" if k else "",
                    next=f"a{s}_{k + 1}_{o}" if k + 1 < n_keys else "",
                    attribute_tokens=[f"attr{attrs.index(attr)}"] if attr else []))
        for i, (tok, key, is_key, ts) in enumerate(chain):
            folder = "samples" if is_key else "sweeps"
            fname = f"{folder}/LIDAR_TOP/{tok}.pcd.bin"
            r = np.minimum(rs.exponential(extent / 3, n_points), extent) + 1.2
            th = rs.uniform(-np.pi, np.pi, n_points)
            pts = np.stack([r * np.cos(th), r * np.sin(th), rs.randn(n_points) * 0.8,
                            rs.uniform(0, 255, n_points), rs.randint(0, 32, n_points)], -1)
            pts.astype(np.float32).tofile(os.path.join(root, fname))
            tabs["sample_data"].append(dict(
                token=tok, sample_token=key, filename=fname, is_key_frame=is_key, timestamp=ts,
                channel="LIDAR_TOP", calibrated_sensor_token=f"cs{s}_{i}", ego_pose_token=f"ep{s}_{i}",
                prev=chain[i - 1][0] if i else "", next=chain[i + 1][0] if i + 1 < len(chain) else ""))
            tabs["ego_pose"].append(dict(token=f"ep{s}_{i}", rotation=_quat_yaw(0.02 * i),
                                         translation=[0.4 * i, 0.1 * i, 0.0]))
            tabs["calibrated_sensor"].append(dict(token=f"cs{s}_{i}", rotation=_quat_yaw(0.01),
                                                  translation=[0.9, 0.0, 1.8]))
            if is_key:
                lab = f"lidarseg/{tok}_lidarseg.bin"
                rs.randint(0, 32, n_points).astype(np.uint8).tofile(os.path.join(root, lab))
                tabs["lidarseg"].append(dict(token=f"ls{tok}", sample_data_token=tok, filename=lab))
    for name, rows in tabs.items():
        with open(os.path.join(root, version, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return version


def write_gt_database(root, name, seed=0, per_class=3, n_points=20):
    """A GT database in the format the port's DataBaseSampler reads (neither
    package's nuScenes preparation writes one): per class `per_class` crops
    of 5-column points inside a box at the origin, `<root>/<name>`."""
    rs = np.random.RandomState(seed)
    sizes = {GENERAL_TO_DETECTION[c]: s for c, _, s in OBJECTS}
    db = {}
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    for cls in CLASSES:
        w, l, h = sizes[cls]
        for i in range(per_class):
            pts = np.concatenate([rs.uniform(-0.45, 0.45, (n_points, 3)) * [l, w, h],
                                  rs.uniform(0, 1, (n_points, 2))], 1).astype(np.float32)
            path = f"gt_database/{cls}_{i}.bin"
            pts.tofile(os.path.join(root, path))
            box = np.array([*rs.uniform(-8, 8, 2), 0.0, l, w, h, *rs.uniform(-1, 1, 2),
                            rs.uniform(-np.pi, np.pi)], np.float32)
            db.setdefault(cls, []).append(dict(name=cls, path=path, box3d_lidar=box,
                                               num_points_in_gt=n_points, difficulty=0))
    with open(os.path.join(root, name), "wb") as f:
        pickle.dump(db, f)
    return db


def prepare_nuscenes(root, nsweeps=(1, 10), **kw):
    """The fixture through the port's create_data: the infos of every
    `nsweeps` (train and val both hold every key frame, as create_data's
    `main` writes them) and a GT database."""
    version = write_nuscenes(root, **kw)
    for ns in nsweeps:
        infos = TC.build_infos(root, version, ns)
        for split in ("train", "val"):
            with open(os.path.join(root, f"infos_{split}_{ns:02d}sweeps_withvelo_filterZero.pkl"),
                      "wb") as f:
                pickle.dump(infos, f)
    write_gt_database(root, "dbinfos_train_10sweeps_withvelo.pkl")
    return version


def nusc_config_file(out_root, data_root, exp, opts_yaml=None):
    """The experiment's config.yaml with `dataset.source` / `eval_source`
    written out (the VoxelNet config does not resolve as written in either
    package), at `<out_root>/playground/<its path>/config.yaml` so the
    port's CLI finds the experiment's net.py; `opts_yaml` edits the dict."""
    with open(ROOT / NUSC / exp / "config.yaml") as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    ns = cfg["dataset"]["nsweeps"]
    source = {"root": data_root, "train": f"/infos_train_{ns:02d}sweeps_withvelo_filterZero.pkl",
              "val": f"/infos_val_{ns:02d}sweeps_withvelo_filterZero.pkl",
              "gt_database": "/dbinfos_train_10sweeps_withvelo.pkl"}
    cfg["dataset"]["source"] = cfg["dataset"]["eval_source"] = source
    cfg["misc"] = {"seed": 42}
    if opts_yaml:
        opts_yaml(cfg)
    path = Path(out_root) / NUSC / exp / "config.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuscenes"))
    write_nuscenes(root)
    return root


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in Path(root).rglob("*") if p.is_file()}


@pytest.mark.parametrize("nsweeps,seg", [(1, False), (4, True)])
def test_create_data_matches(nusc_root, tmp_path, monkeypatch, nsweeps, seg):
    """`main` of both packages on the same tables: the pickles' infos equal
    field by field (sweep chains, transforms, boxes, velocities, names,
    attributes, lidarseg records)."""
    out = {}
    for tag, mod in (("efg_tpu", JC), ("port", TC)):
        argv = ["create_data", "--root", nusc_root, "--version", VERSION, "--nsweeps",
                str(nsweeps), "--split", tag] + (["--seg"] if seg else [])
        monkeypatch.setattr(sys, "argv", argv)
        mod.main()
        with open(os.path.join(nusc_root, f"infos_{tag}_{nsweeps:02d}sweeps_withvelo_filterZero"
                                          ".pkl"), "rb") as f:
            out[tag] = pickle.load(f)
    _equal(out["efg_tpu"], out["port"], "infos")
    infos = out["port"]
    assert len(infos) == 6
    assert {len(i["LIDAR_TOP"]["sweeps"]) for i in infos} == {nsweeps - 1}
    ann = infos[1]["annotations"]
    assert ann["gt_boxes"].shape == (len(OBJECTS), 9) and np.abs(ann["gt_boxes"][:, 6:8]).max() > 0
    assert "vehicle.car" in ann["gt_names"] and "" in ann["gt_attrs"]
    assert ("lidarseg" in ann) == seg


def test_nuscenes2kitti_files_equal(nusc_root, tmp_path):
    """Both converters write the same files, byte for byte."""
    n_j = JK.convert_scenes(nusc_root, str(tmp_path / "efg_tpu"), VERSION)
    n_t = TK.convert_scenes(nusc_root, str(tmp_path / "port"), VERSION)
    assert n_j == n_t == 6
    want, got = _files(tmp_path / "efg_tpu"), _files(tmp_path / "port")
    assert sorted(want) == sorted(got) and len(got) == 2 * (3 + 3 + 4)
    for k in want:
        assert want[k] == got[k], k


def _infos(root, nsweeps, tag, efg_form=False):
    """create_data's infos at `<root>/infos_<tag>_<nsweeps>sweeps.pkl`;
    `efg_form` turns them into the form the port's dataset makes of them
    when it loads them (`to_efg_frame`: the detection classes' names, the
    boxes in the EFG frame), the form efg_tpu's dataset needs to read the
    same items. Returns the path under `root`."""
    infos = TC.build_infos(root, VERSION, nsweeps)
    if efg_form:
        for info in infos:
            to_efg_frame(info["annotations"])
    path = f"/infos_{tag}_{nsweeps:02d}sweeps.pkl"
    with open(root + path, "wb") as f:
        pickle.dump(infos, f)
    return path


def _dataset_config(out_root, root, infos, nsweeps=4, cbgs=False):
    def edit(cfg):
        d = cfg["dataset"]
        d["source"] = d["eval_source"] = {"root": root, "train": infos, "val": infos}
        d.update(nsweeps=nsweeps, cbgs=cbgs)
        for split in ("train", "val"):
            d["processors"][split][-1]["PadPoints"]["num_points"] = 2048

    return nusc_config_file(out_root, root, PILLAR_EXP, edit)


def _datasets(out_root, root, task, nsweeps=4, cbgs=False, seed=None):
    """efg_tpu's dataset on the infos in the EFG form and the port's on
    create_data's own, both from the Pillar experiment's config; `seed`
    seeds numpy before each (CBGS draws when the infos load)."""
    out = []
    for tag, pkg, config, efg_form in (("efg", JD, JConfiguration, True),
                                       ("raw", TD, Configuration, False)):
        infos = _infos(root, nsweeps, tag, efg_form)
        path = _dataset_config(os.path.join(out_root, tag), root, infos, nsweeps, cbgs)
        if seed is not None:
            np.random.seed(seed)
        out.append(pkg.build_dataset(config(config_file=path, opts=[f"task={task}"]).get_config()))
    return out


def test_train_items_equal(nusc_root, tmp_path):
    """Train items at 4 sweeps (the key frame and 3 sweeps moved into its
    frame, a time-lag column, the x, y → y, −x swap) through the Pillar
    experiment's augmentations, item by item from one numpy seed: points
    and annotations exact."""
    jds, tds = _datasets(str(tmp_path), nusc_root, "train")
    assert len(jds) == len(tds) == 6
    for idx in range(len(tds)):
        np.random.seed(50 + idx)
        want = jds[idx]
        np.random.seed(50 + idx)
        got = tds[idx]
        _equal(want, got, f"item {idx}")
        lags = np.unique(got[0]["points"][got[0]["points_mask"], 4])
        assert len(lags) == 4
        labels = got[1]["annotations"]["labels"]
        assert 0 < len(labels) <= len(OBJECTS) - 1 and set(labels) <= set(range(1, 11))


def test_val_items_are_labelled_where_efg_tpu_leaves_them(nusc_root, tmp_path):
    """Val items: points equal efg_tpu's; the port's annotations are
    efg_tpu's filtered to the classes and labelled (its stated deviation),
    and efg_tpu's unlabelled GT cannot be batched by its own collate."""
    jds, tds = _datasets(str(tmp_path), nusc_root, "val")
    want, got = jds[2], tds[2]
    _equal(want[0], got[0], "points")
    wa, ga = want[1]["annotations"], got[1]["annotations"]
    assert "labels" not in wa and "animal" not in wa["gt_names"]  # mapped to "ignore"
    keep = np.isin(wa["gt_names"], CLASSES)
    for k in ("gt_boxes", "gt_names", "gt_attrs"):
        np.testing.assert_array_equal(ga[k], wa[k][keep], err_msg=k)
    np.testing.assert_array_equal(ga["labels"], [CLASSES.index(n) + 1 for n in ga["gt_names"]])
    with pytest.raises(KeyError, match="labels"):
        JB.collate_fixed([want], max_gt=500)
    batch = TB.collate_fixed([got], max_gt=500)
    assert int(batch["gt_mask"].sum()) == len(ga["labels"])


def test_category_names_map_to_the_classes(nusc_root, tmp_path):
    """On the infos as create_data writes them (nuScenes' category names),
    efg_tpu's train items keep no GT box; the port's map every name through
    GENERAL_TO_DETECTION, drop "animal" ("ignore"), and label the rest."""
    infos = _infos(nusc_root, 1, "as_written")
    path = _dataset_config(str(tmp_path), nusc_root, infos, nsweeps=1)
    jc = JConfiguration(config_file=path, opts=["task=train"]).get_config()
    tc = Configuration(config_file=path, opts=["task=train"]).get_config()
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    np.random.seed(7)
    want = jds[0]
    np.random.seed(7)
    got = tds[0]
    _equal(want[0], got[0], "points")
    assert len(want[1]["annotations"]["gt_boxes"]) == 0
    names = got[1]["annotations"]["gt_names"]
    assert 0 < len(names) <= len(OBJECTS) - 1 and set(names) <= set(CLASSES)


def test_cbgs_resamples_the_same_list(nusc_root, tmp_path):
    """CBGS at info-load time on create_data's own infos: the port's list
    grows past the 6 key frames and equals efg_tpu's on the EFG form under
    the same numpy seed; efg_tpu on create_data's own infos finds no class
    and keeps the 6."""
    jds, tds = _datasets(str(tmp_path), nusc_root, "train", nsweeps=1, cbgs=True, seed=3)
    tokens = [i["sample_token"] for i in tds.dataset_dicts]
    assert tokens == [i["sample_token"] for i in jds.dataset_dicts]
    assert len(tokens) > 6
    path = _dataset_config(str(tmp_path), nusc_root, _infos(nusc_root, 1, "as_written"),
                           nsweeps=1, cbgs=True)
    assert len(JD.build_dataset(JConfiguration(config_file=path,
                                               opts=["task=train"]).get_config())) == 6


def _points_in_boxes(points, boxes):
    """[N, B] whether each point lies in each box (x, y, z, l, w, h, …,
    yaw), the box's centre at its middle."""
    d = points[:, None, :3] - boxes[None, :, :3]
    c, s = np.cos(boxes[:, -1]), np.sin(boxes[:, -1])
    u, v = d[..., 0] * c + d[..., 1] * s, -d[..., 0] * s + d[..., 1] * c
    return (np.abs(u) <= boxes[:, 3] / 2) & (np.abs(v) <= boxes[:, 4] / 2) & \
        (np.abs(d[..., 2]) <= boxes[:, 5] / 2)


def test_boxes_line_up_with_their_points(tmp_path):
    """The fixture's key frames with 20 points inside every annotated
    object, placed in nuScenes' lidar frame by create_data's own boxes: in
    the port's val items every box holds its own 20 points; in efg_tpu's,
    whose points turn into the EFG frame and whose boxes do not, the 12
    boxes hold at most 20 of their 240 (3 and 8 on this fixture)."""
    root = str(tmp_path / "nuscenes")
    write_nuscenes(root, n_scenes=1, n_keys=2, n_sweeps=1)
    rs = np.random.RandomState(4)
    for info in TC.build_infos(root, VERSION, 1):
        boxes = info["annotations"]["gt_boxes"]
        local = rs.uniform(-0.4, 0.4, (len(boxes), 20, 3)) * boxes[:, None, 3:6]
        c, s = np.cos(boxes[:, 8])[:, None], np.sin(boxes[:, 8])[:, None]
        xyz = np.stack([local[..., 0] * c - local[..., 1] * s + boxes[:, None, 0],
                        local[..., 0] * s + local[..., 1] * c + boxes[:, None, 1],
                        local[..., 2] + boxes[:, None, 2]], -1).reshape(-1, 3)
        pts = np.concatenate([xyz, np.zeros((len(xyz), 2))], 1).astype(np.float32)
        pts.tofile(info["LIDAR_TOP"]["data_path"])
    jds, tds = _datasets(str(tmp_path), root, "val", nsweeps=1)
    path = _dataset_config(str(tmp_path / "as_written"), root, _infos(root, 1, "as_written"),
                           nsweeps=1)
    jds_as_written = JD.build_dataset(JConfiguration(config_file=path,
                                                     opts=["task=val"]).get_config())
    own = np.arange(20 * len(OBJECTS)) // 20  # the box each written point belongs to
    for idx in range(2):
        counts = []
        for ds, n_boxes in ((tds, len(OBJECTS) - 1), (jds_as_written, len(OBJECTS))):
            points, info = ds[idx]
            boxes = info["annotations"]["gt_boxes"]
            assert len(boxes) == n_boxes and int(points["points_mask"].sum()) == len(own)
            inside = _points_in_boxes(points["points"][: len(own)], boxes)
            counts.append(np.bincount(own[own < n_boxes], inside[own < n_boxes,
                                                               own[own < n_boxes]],
                                      minlength=n_boxes).astype(int))
        assert (counts[0] == 20).all(), counts[0]
        assert counts[1].sum() <= 20, counts[1]
        _equal(jds[idx][0], tds[idx][0], "points")


def _eval_frames(seed, n_frames=4):
    """(inputs, outputs) batches of one frame: GT of the 10 classes with
    attributes and velocities, predictions near some GT with seeded
    errors, false positives, and an empty frame (no GT, no prediction)."""
    rs = np.random.RandomState(seed)
    attrs = {1: "vehicle.moving", 2: "vehicle.parked", 3: "vehicle.stopped", 4: "vehicle.moving",
             5: "vehicle.parked", 6: "", 7: "cycle.with_rider", 8: "cycle.without_rider",
             9: "pedestrian.standing", 10: ""}
    out = []
    for f in range(n_frames):
        g = 0 if f == n_frames - 1 else 14
        gt = np.zeros((g, 9), np.float32)
        gt[:, :2] = rs.uniform(-40, 40, (g, 2))
        gt[:, 2] = rs.uniform(-1, 1, g)
        gt[:, 3:6] = rs.uniform(0.5, 5, (g, 3))
        gt[:, 6:8] = rs.uniform(-3, 3, (g, 2)) * (rs.uniform(size=(g, 1)) > 0.4)
        gt[:, 8] = rs.uniform(-np.pi, np.pi, g)
        labels = rs.randint(1, 11, g)
        gt_attrs = np.asarray([attrs[int(c)] if rs.uniform() > 0.2 else "" for c in labels])
        k = 24
        det = np.zeros((k, 9), np.float32)
        dl = rs.randint(1, 11, k)
        n_near = min(g, 16)
        near = rs.permutation(g)[:n_near]
        det[:n_near] = gt[near]
        dl[:n_near] = labels[near]
        det[:n_near, :2] += rs.randn(n_near, 2) * rs.choice([0.1, 0.6, 1.5, 3.0], (n_near, 1))
        det[:n_near, 3:6] *= rs.uniform(0.8, 1.2, (n_near, 3))
        det[:n_near, 6:8] += rs.randn(n_near, 2) * 0.3
        det[:n_near, 8] += rs.randn(n_near) * 0.3
        det[n_near:, :2] = rs.uniform(-40, 40, (k - n_near, 2))
        det[n_near:, 3:6] = rs.uniform(0.5, 5, (k - n_near, 3))
        valid = np.ones(k, bool)
        valid[-3:] = False
        if f == n_frames - 1:
            valid[:] = False
        inputs = {"annotations": [dict(gt_boxes=gt, labels=labels.astype(np.int64),
                                       gt_attrs=gt_attrs)]}
        outputs = {"box3d": det[None], "scores": rs.uniform(0.05, 1, (1, k)).astype(np.float32),
                   "labels": dl[None], "valid": valid[None]}
        out.append((inputs, outputs))
    return out


def test_evaluator_matches_efg_tpu():
    """The same result dict as efg_tpu's on seeded predictions over 4
    frames (attributes, the barrier / cone exclusions, an empty frame);
    then every GT as a prediction scores the perfect mAP of efg_tpu's
    normalisation and errors of exactly 0."""
    from types import SimpleNamespace

    cfg = SimpleNamespace(dataset=SimpleNamespace(classes=CLASSES))
    je, te = JEvaluator(cfg, None), TEvaluator(cfg, None)
    for inputs, outputs in _eval_frames(11):
        je.process(inputs, outputs)
        te.process(inputs, outputs)
    want, got = je.evaluate(), te.evaluate()
    assert set(got) == set(want) and len(got) == 10 + 7
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)
    assert 0 < got["nusc/mAP"] < 1 and 0 < got["nusc/mAAE"] < 1
    te = TEvaluator(SimpleNamespace(dataset=SimpleNamespace(classes=CLASSES)), None)
    for inputs, _ in _eval_frames(12):
        a = inputs["annotations"][0]
        n = len(a["labels"])
        te.process(inputs, {"box3d": a["gt_boxes"][None], "scores": np.ones((1, n), np.float32),
                            "labels": a["labels"][None], "valid": np.ones((1, n), bool)})
    res = te.evaluate()
    # a perfect detector under efg_tpu's normalisation, mean(prec − 0.1) /
    # 0.9 over its 90 recall points of precision 1: 1 + 4.4e-16 in f64
    assert res["nusc/mAP"] == np.clip(np.ones(90) - 0.1, 0, None).mean() / 0.9 > 1.0
    assert res["nusc/mATE"] == res["nusc/mASE"] == res["nusc/mAOE"] == res["nusc/mAVE"] == 0.0
