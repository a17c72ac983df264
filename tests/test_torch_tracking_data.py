"""Port parity: the tracking data path (efg_tpu_torch vs efg_tpu) and the
witnesses of efg_tpu's tracking faults, each fixed, stated or refused in
the port (ROADMAP queue 3).

`SyntheticTrackingDataset` items and loader batches (detection and
trajectory fields) bit for bit; `SeqInferenceSampler`'s order on one
process and its shards over machines; `WaymoTrackingDataset` on
Waymo-format fixture frames (`tests/test_torch_waymo_data.py`'s) with a
boxes pkl: the val items equal but for the port's additions, and the
faults:
1. the Waymo motion pretrain: efg_tpu's step reads `traj_hist`, which its
   dataset never writes (KeyError); the port refuses the config;
2. the detections' labels: efg_tpu labels detection i with GT i's class,
   the port with the detection's own;
3. the train augmentations: efg_tpu's leave the detections where they
   were, off their points; the port's move them with the points;
4. `--local-ranks 2` evaluation: local rank 0 reads every frame, the
   other's slice is padding, and the evaluator's gather does not hang;
5. the GT's track ids: efg_tpu's items have none, and its
   `TrackingEvaluator` fails on them; the port's carry them."""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

import efg_tpu.data as JD
import efg_tpu_torch.data as TD
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.data import builder as JB
from efg_tpu.evaluator import tracking_evaluator as JTE
from efg_tpu.models import trajectoryformer as JTF
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data import builder as TB
from efg_tpu_torch.evaluator import tracking_evaluator as TTE
from efg_tpu_torch.geometry import box_ops_np as TG
from efg_tpu_torch.models import trajectoryformer as TTF
from efg_tpu_torch.utils import distributed as comm

from test_torch_data import _equal
from test_torch_waymo_data import PC_RANGE, prepare_waymo

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SYNTH_DIR = "playground/tracking.3d/synthetic"
SYNTH = str(ROOT / SYNTH_DIR / "trajectoryformer.synth/config.yaml")
PRETRAIN = str(ROOT / SYNTH_DIR / "trajectoryformer.motionpred.pretrain/config.yaml")
WAYMO_DIR = "playground/tracking.3d/waymo/trajectoryformer"
TF_EXP = "trajectoryformer.centerpoint"
PRETRAIN_EXP = "trajectoryformer.motionpred.pretrain"
LABEL_OF = {1: 1, 2: 2, 4: 3}  # the decoder's object label → the experiment's class


def _configs(path, opts=()):
    return (JConfiguration(config_file=path, opts=list(opts)).get_config(),
            Configuration(config_file=path, opts=list(opts)).get_config())


# --------------------------------------------------------------- synthetic

@pytest.mark.parametrize("path,task", [(SYNTH, "train"), (SYNTH, "val"), (PRETRAIN, "train")])
def test_synthetic_items_and_batches_equal(path, task):
    """Items bit for bit, but for the port's `det_labels` (GT i's label:
    detection i is GT i's noisy copy); two loader batches, the port's with
    `det_labels` too."""
    jc, tc = _configs(path, [f"task={task}"])
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    assert len(jds) == len(tds) == 32 and jds.sequence_ids == tds.sequence_ids
    for idx in (0, 9, 31):
        (jd, ji), (td, ti) = jds[idx], tds[idx]
        det_labels = ti["annotations"].pop("det_labels")
        np.testing.assert_array_equal(det_labels, ji["annotations"]["labels"])
        _equal(jd, td, f"data[{idx}]")
        _equal(ji, ti, f"info[{idx}]")
    jl, tl = JB.build_dataloader(jc, jds, train=task == "train"), TB.build_dataloader(
        tc, tds, train=task == "train")
    for k, (jb, tb) in enumerate(zip(iter(jl), iter(tl))):
        assert set(tb) == set(jb) | {"det_labels"}
        assert ("traj_hist" in tb) == (path == PRETRAIN)
        np.testing.assert_array_equal(tb["det_labels"], np.where(jb["det_mask"], jb["gt_classes"], 0))
        for a in tb["annotations"]:
            a.pop("det_labels")
        _equal({k_: jb[k_] for k_ in jb}, {k_: tb[k_] for k_ in jb}, f"batch {k}")
        if k == 1:
            break


def test_seq_sampler_order():
    """One process: the port's sampler, given the dataset's sequence ids,
    reads efg_tpu's order (efg_tpu builds it from the length alone, one
    sequence). Two machines: whole sequences each, in order."""
    jc, tc = _configs(SYNTH, ["task=val", "dataloader.eval_sampler=SeqInferenceSampler"])
    tds = TD.build_dataset(tc)
    want = list(JB.build_dataloader(jc, JD.build_dataset(jc), train=False).sampler)
    assert list(TB.build_dataloader(tc, tds, train=False).sampler) == want == list(range(32))
    from efg_tpu_torch.data.samplers.dataset_sampler import SeqInferenceSampler

    seqs = ["b", "b", "a", "a", "a", "c", "c", "d"]
    shards = []
    for rank in range(2):
        comm_state = (comm.get_machine_rank, comm.get_num_machines)
        try:
            comm.get_machine_rank, comm.get_num_machines = (lambda r=rank: r), (lambda: 2)
            shards.append(list(SeqInferenceSampler(len(seqs), seqs)))
        finally:
            comm.get_machine_rank, comm.get_num_machines = comm_state
    assert shards == [[2, 3, 4, 5, 6], [0, 1, 7]]


def test_refusal_of_a_batched_sequence_split(monkeypatch):
    """Several local ranks and eval_batch_size > 1 would hand each rank's
    tracker every other frame: refused."""
    _, tc = _configs(SYNTH, ["task=val", "dataloader.eval_sampler=SeqInferenceSampler",
                             "dataloader.eval_batch_size=2"])
    monkeypatch.setattr(comm, "get_local_size", lambda: 2)
    with pytest.raises(ValueError, match="every other frame"):
        TB.build_dataloader(tc, TD.build_dataset(tc), train=False)


# ---------------------------------------------------------- Waymo frames

@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    """The Waymo fixture frames (2 train sequences of 4 frames, 4 val
    frames) and a boxes pkl a split: each frame's GT of the three classes
    as detections, in reverse order, with scores, the frame's decoder labels mapped to the
    experiment's classes, and one extra pedestrian detection."""
    root = str(tmp_path_factory.mktemp("waymo_track"))
    prepare_waymo(root)
    for split in ("train", "val"):
        with open(os.path.join(root, f"infos_{split}_01sweeps_sampled.pkl"), "rb") as fh:
            infos = pickle.load(fh)
        dets = []
        for info in infos:
            with open(os.path.join(root, info["anno_path"]), "rb") as fh:
                objs = [o for o in pickle.load(fh)["objects"][::-1] if o["label"] in LABEL_OF]
            boxes = np.asarray([o["box"] for o in objs] + [[1.0, 1.0, 0.0, 0.9, 0.8, 1.7, 0, 0, 0]],
                               np.float32)
            labels = np.asarray([LABEL_OF[o["label"]] for o in objs] + [2], np.int64)
            scores = np.linspace(0.9, 0.3, len(boxes)).astype(np.float32)
            dets.append({"boxes3d": boxes, "scores": scores, "labels": labels})
        with open(os.path.join(root, f"boxes_{split}.pkl"), "wb") as fh:
            pickle.dump(dets, fh)
    return root


def tracking_config_file(out_root, data_root, exp=TF_EXP):
    """The experiment's config.yaml with `dataset.source` and the boxes
    paths written out, cut to the fixture's size, at `<out_root>/playground/<its path>`."""
    with open(ROOT / WAYMO_DIR / exp / "config.yaml") as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("includes")
    d = cfg["dataset"]
    d["source"] = {"root": data_root, "train": "/infos_train_01sweeps_sampled.pkl",
                   "val": "/infos_val_01sweeps_sampled.pkl",
                   "test": "/infos_val_01sweeps_sampled.pkl"}
    d["train_boxes_path"] = os.path.join(data_root, "boxes_train.pkl")
    d["val_boxes_path"] = os.path.join(data_root, "boxes_val.pkl")
    d["pc_range"] = PC_RANGE
    for split in ("train", "val"):
        d["processors"][split][-1]["PadPoints"]["num_points"] = 2048
    cfg["dataloader"] = {"num_workers": 0, "batch_size": 2, "eval_batch_size": 1,
                         "eval_sampler": "SeqInferenceSampler"}
    cfg["model"].pop("motion_model", None)
    cfg["misc"] = {"seed": 42}
    path = Path(out_root) / WAYMO_DIR / exp / "config.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def config_file(waymo_root, tmp_path_factory):
    return tracking_config_file(str(tmp_path_factory.mktemp("exp")), waymo_root)


def test_waymo_val_items_equal(config_file):
    """Val items: points, GT and detections (with their labels) equal;
    the port adds the GT's track ids, each object's id the same integer
    in every frame of its sequence."""
    jc, tc = _configs(config_file, ["task=val"])
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    assert jds.sequence_ids == tds.sequence_ids == ["seq_0"] * 4
    ids = []
    for idx in range(len(jds)):
        (jd, ji), (td, ti) = jds[idx], tds[idx]
        ids.append(sorted(ti["annotations"].pop("track_ids").tolist()))
        _equal(jd, td, "data")
        _equal(ji, ti, "info")
    assert len(ids[0]) == 7 and ids[0] == ids[-1]


def _batch(ds, idx, max_gt):
    return TB.collate_fixed([ds[i] for i in idx], max_gt)


def test_fault_2_detection_labels(config_file):
    """efg_tpu's `det_predict` labels detection slot i with GT i's class;
    the detections here are the GT in reverse order plus a pedestrian, so
    its labels follow the GT order. The port's are the detections' own."""
    jc, tc = _configs(config_file, ["task=val"])
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    jb = JB.collate_fixed([jds[0]], 128)
    tb = _batch(tds, [0], 128)
    outputs = dict(scores=np.zeros((1, 128), np.float32), refine=np.zeros((1, 128, 7), np.float32))
    jl = np.asarray(JTF.det_predict({k: jnp.asarray(v) for k, v in outputs.items()},
                                    {k: jnp.asarray(v) for k, v in jb.items()
                                     if isinstance(v, np.ndarray)})["labels"])
    tl = TTF.det_predict({k: torch.from_numpy(v) for k, v in outputs.items()},
                         {k: torch.from_numpy(v) for k, v in tb.items()
                          if isinstance(v, np.ndarray)})["labels"].numpy()
    det = jds.boxes_dicts[0]
    n = len(det["labels"])
    want = det["labels"][np.argsort(-det["scores"])]
    np.testing.assert_array_equal(tl[0, :n], want)
    assert (jl[0, :n] != want).any()  # efg_tpu's: the GT slots' classes
    np.testing.assert_array_equal(jl[0, :n - 1], jb["gt_classes"][0, :n - 1])
    assert jl[0, n - 1] == 0  # past the GT count: no class, dropped by the evaluator


def _points_inside(points, mask, boxes):
    pts = points[mask]
    return TG.points_in_rbbox(pts[:, :3], boxes).sum(0)


def test_fault_3_augmented_detections_stay_on_their_points(config_file):
    """The train processors (flips, rotation, scaling, range filter,
    shuffle) from one numpy seed, on detections that are the GT: every
    GT box of the port's item has an equal detection box, holding the
    same points; efg_tpu's detections stay where they were, and hold
    fewer than half of the points (3-64 of 115-217 a frame here)."""
    jc, tc = _configs(config_file, ["task=train"])
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    for idx in range(len(jds)):
        np.random.seed(100 + idx)
        jd, ji = jds[idx]
        np.random.seed(100 + idx)
        td, ti = tds[idx]
        _equal(jd, td, "points")
        ja, ta = ji["annotations"], ti["annotations"]
        np.testing.assert_array_equal(ja["gt_boxes"], ta["gt_boxes"])
        pts, mask = td["points"], td["points_mask"]
        gt_in = _points_inside(pts, mask, ta["gt_boxes"])
        seen = {}
        for name, a in (("port", ta), ("efg_tpu", ja)):
            pairs = [[j for j, d in enumerate(a["det_boxes"]) if np.array_equal(g, d)]
                     for g in a["gt_boxes"]]
            seen[name] = sum(bool(p) for p in pairs)
            held = _points_inside(pts, mask, a["det_boxes"][:-1]).sum()  # the last: the extra
            seen[f"{name}_points"] = int(held)
        assert seen["port"] == len(ta["gt_boxes"]) and seen["port_points"] >= gt_in.sum()
        assert seen["efg_tpu"] == 0 and seen["efg_tpu_points"] < gt_in.sum() / 2


def test_fault_1_waymo_pretrain(waymo_root, tmp_path, monkeypatch):
    """efg_tpu's Waymo pretrain: its loader's batch has no `traj_hist`,
    which its model reads (KeyError at the first step). The port refuses
    the config when it builds the dataset, through the CLI."""
    import importlib.util

    path = tracking_config_file(str(tmp_path), waymo_root, exp=PRETRAIN_EXP)
    jc, _ = _configs(path, ["task=train"])
    jds = JD.build_dataset(jc)
    batch = next(iter(JB.build_dataloader(jc, jds, train=True)))
    spec = importlib.util.spec_from_file_location(
        "efg_tpu_pretrain_net", ROOT / WAYMO_DIR / PRETRAIN_EXP / "net.py")
    net = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(net)
    with pytest.raises(KeyError, match="traj_hist"):
        net.build_model(jc).apply_args(batch)

    from efg_tpu_torch.cli import main as cli

    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(NotImplementedError, match="builds no object trajectories"):
        cli.main(["--config", path, "--device", "cpu", "task=train"])


def test_fault_5_gt_track_ids(config_file):
    """efg_tpu's `TrackingEvaluator` on its Waymo items: no `track_ids`,
    and its evaluate fails indexing them; the port's items carry them and
    the GT as tracks read MOTA 1."""
    jc, tc = _configs(config_file, ["task=val"])
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    jev, tev = JTE.TrackingEvaluator(jc, jds), TTE.TrackingEvaluator(tc, tds)
    for ev, ds in ((jev, jds), (tev, tds)):
        ev.reset()
        for idx in range(len(ds)):
            _, info = ds[idx]
            a = info["annotations"]
            tracks = [dict(translation=b[:3].tolist(), tracking_id=i, label=int(lb) - 1)
                      for i, (b, lb) in enumerate(zip(a["gt_boxes"], a["labels"]))]
            ev.process({"annotations": [a], "metadata": [info["metadata"]]},
                       dict(tracks=[tracks]))
    with pytest.raises(IndexError):
        jev.evaluate()
    tev.reset()
    for idx in range(len(tds)):
        _, info = tds[idx]
        a = info["annotations"]
        tracks = [dict(translation=b[:3].tolist(), tracking_id=int(i), label=int(lb) - 1)
                  for b, i, lb in zip(a["gt_boxes"], a["track_ids"], a["labels"])]
        tev.process({"annotations": [a], "metadata": [info["metadata"]]}, dict(tracks=[tracks]))
    assert tev.evaluate()["tracking/MOTA"] == 1.0


def _evaluation(log):
    m = re.findall(r"Evaluation results: (\{.*\})", Path(log).read_text())
    assert len(m) == 1, log
    return m[0]


def test_fault_4_two_local_ranks_evaluate(tmp_path):
    """`--local-ranks 2 task=val` of the synthetic experiment: local rank 0
    reads every frame (eval_batch_size 1), rank 1's slice is padding, the
    evaluator's gather returns; the results equal one process's."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    opts = ["task=val", "dataloader.eval_sampler=SeqInferenceSampler"]
    results = []
    for ranks in (2, 1):
        env["EFG_CACHE_DIR"] = str(tmp_path / f"ranks{ranks}")
        out = subprocess.run([sys.executable, "-m", "efg_tpu_torch.cli.main", "--config", SYNTH,
                              "--device", "cpu", "--local-ranks", str(ranks), *opts],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        log = tmp_path / f"ranks{ranks}" / "EFG_torch" / "tracking.3d/synthetic" / \
            "trajectoryformer.synth" / "log.txt.rank0"
        results.append(_evaluation(log))
    assert results[0] == results[1] and "tracking/MOTA" in results[0]
