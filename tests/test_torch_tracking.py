"""Port parity: the trackers and the tracking evaluators (efg_tpu_torch vs
efg_tpu) on the same frames, and the synthetic tracking experiment
through the port's CLI against efg_tpu's trainer.

`greedy_assignment` and `GreedyTracker` bit for bit, track ids over a
whole synthetic sequence; `TrajectoryFormerTracker` from the same weights
(efg_tpu's flax init mapped by `flax_to_state_dict`): scores and refined
boxes within 1e-5 on every frame, track ids equal over the sequence;
`MOTAccumulator`, `WaymoTrackingMetric` and `TrackingEvaluator` (fed raw
detections, its internal tracker running) with equal results; efg_tpu's
own hand-traced metric cases on the port's copies. Then the experiment
`tracking.3d/synthetic/trajectoryformer.synth`: efg_tpu's DefaultTrainer
in a one-device subprocess (`jax_trainer_output`, shared with the other
trainer parity files) and the port's CLI, resumed from a step-0
checkpoint of efg_tpu's initial weights, agree on the first 3 steps'
losses."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

import efg_tpu.data as JD
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.evaluator import tracking_evaluator as JTE
from efg_tpu.evaluator import waymo_tracking as JWT
from efg_tpu.models import trajectoryformer as JTF
from efg_tpu.tracking import tf_tracker as JTFT
from efg_tpu.tracking import tracker as JT
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.evaluator import tracking_evaluator as TTE
from efg_tpu_torch.evaluator import waymo_tracking as TWT
from efg_tpu_torch.models import trajectoryformer as TTF
from efg_tpu_torch.tracking import tf_tracker as TTFT
from efg_tpu_torch.tracking import tracker as TT
from efg_tpu_torch.utils.jax_import import flax_to_state_dict

# one intra-op thread: the workers of the parallel test run share the cores,
# which torch's thread pool in each of them would oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SYNTH = str(ROOT / "playground/tracking.3d/synthetic/trajectoryformer.synth/config.yaml")
CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_frames(n_seq=2, frames=8, opts=("dataset.det_noise=0.3",)):
    """The synthetic experiment's val items (efg_tpu's dataset)."""
    cfg = JConfiguration(config_file=SYNTH, opts=["task=val", f"dataset.num_sequences={n_seq}",
                                                  f"dataset.frames_per_seq={frames}",
                                                  *opts]).get_config()
    ds = JD.build_dataset(cfg)
    return [ds[i] for i in range(len(ds))]


def _detections(info, drop=()):
    a = info["annotations"]
    return [dict(translation=b[:3].tolist(), velocity=b[6:8].tolist(),
                 detection_name=CLASSES[int(lb) - 1], score=float(s), box=b.copy())
            for i, (b, s, lb) in enumerate(zip(a["det_boxes"], a["det_scores"], a["labels"]))
            if i not in drop]


@pytest.fixture
def jit_reference_iou(monkeypatch):
    """efg_tpu's tracking metric with its IoU matrix through its `iou_3d`
    under jit on padded boxes (`tests/test_torch_evaluator.py`: eagerly it
    compiles for every new shape)."""
    from test_torch_evaluator import jax_iou

    def bev_iou_matrix(pred, gt):
        if pred.shape[0] == 0 or gt.shape[0] == 0:
            return np.zeros((pred.shape[0], gt.shape[0]), np.float32)
        return jax_iou(pred, gt)

    monkeypatch.setattr(JWT, "_bev_iou_matrix", bev_iou_matrix)


def _assert_results_equal(got, want):
    """Equal results; MOTP (a mean of 1 − IoU, each IoU an f32 polygon
    clip in either package's order) within 1e-6."""
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("MOTP"):
            assert got[k] == pytest.approx(w, abs=1e-6), k
        else:
            assert got[k] == w, k


def _ids(tracks):
    return [(t["tracking_id"], t["detection_name"], t["age"], t["active"]) for t in tracks]


# -------------------------------------------------------------- trackers

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_assignment_matches(seed):
    rs = np.random.RandomState(seed)
    dist = rs.uniform(0, 5, (7, 5))
    dist[rs.uniform(size=dist.shape) < 0.3] += 1e18
    dist[:, 2] = 3.0  # ties
    np.testing.assert_array_equal(TT.greedy_assignment(dist.copy()),
                                  JT.greedy_assignment(dist.copy()))
    assert TT.greedy_assignment(np.zeros((3, 0))).shape == (0, 2)


def test_greedy_tracker_ids_match_over_sequences():
    """Both trackers over two synthetic sequences (frames with a
    detection dropped, so tracks coast and die): tracks, ids, ages and
    centres equal at every frame."""
    frames = _synthetic_frames()
    jt, tt = JT.GreedyTracker(max_age=2), TT.GreedyTracker(max_age=2)
    n_ids = set()
    for k, (_, info) in enumerate(frames):
        if info["metadata"]["frame"] == 0:
            jt.reset()
            tt.reset()
        dets = _detections(info, drop=(0,) if k % 3 == 1 else ())
        want, got = jt.step(dets, 0.1), tt.step(dets, 0.1)
        assert _ids(got) == _ids(want), k
        np.testing.assert_array_equal([t["ct"] for t in got], [t["ct"] for t in want])
        n_ids |= {t["tracking_id"] for t in got}
    assert len(n_ids) > 4


def _tf_trackers(weight_seed=3, d_model=32, points=16, history=3, n_max=16):
    jm = JTF.TrajectoryFormer(d_model=d_model, num_layers=1, num_points=points, history=history)
    dummy = dict(hyp_points=jnp.zeros((n_max, points, 4)), hyp_pts_mask=jnp.ones((n_max, points), bool),
                 hyp_traj=jnp.zeros((n_max, history, 8)),
                 hyp_traj_mask=jnp.ones((n_max, history), bool), hyp_boxes=jnp.zeros((n_max, 7)),
                 group_ids=jnp.arange(n_max), valid=jnp.ones(n_max, bool))
    variables = jax.device_get(jax.jit(lambda k: jm.init(k, **dummy, train=False))(
        jax.random.key(weight_seed)))
    # a non-zero regression head, so that the refinement moves the boxes
    reg = variables["params"]["reg_head"]
    reg["kernel"] = np.random.RandomState(weight_seed).randn(*reg["kernel"].shape).astype(
        np.float32) * np.float32(0.02)
    tm = TTF.TrajectoryFormer(d_model, 1, points, history)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    kw = dict(class_names=CLASSES, max_candidates=n_max, history=history, num_points=points,
              score_fuse=0.3)
    return JTFT.TrajectoryFormerTracker(jm, variables, **kw), TTFT.TrajectoryFormerTracker(tm, **kw)


def test_trajectoryformer_tracker_matches_over_a_sequence():
    """Both trackers over a synthetic sequence: each frame's scoring call
    (scores and refined boxes within 1e-5) and the tracks after it (ids,
    ages, classes) equal; the candidates include every live track's
    motion-predicted box and its history."""
    frames = _synthetic_frames(n_seq=1)
    jt, tt = _tf_trackers()
    calls = {"jax": [], "torch": []}
    j_score, t_score = jt._score, tt.score

    def jrec(*a):
        out = j_score(*a)
        calls["jax"].append(tuple(np.asarray(o) for o in out))
        return out

    def trec(*a):
        out = t_score(*a)
        calls["torch"].append(tuple(o.numpy() for o in out))
        return out

    jt._score, tt.score = jrec, trec
    for k, (data, info) in enumerate(frames):
        dets = _detections(info)
        want = jt.step(data["points"][:, :4], data["points_mask"], dets)
        got = tt.step(data["points"][:, :4], data["points_mask"], dets)
        assert _ids(got) == _ids(want), k
        np.testing.assert_allclose([t["box"] for t in got], [t["box"] for t in want], atol=1e-5)
    assert len(calls["jax"]) == len(calls["torch"]) == len(frames)
    for (js, jr), (ts, tr) in zip(calls["jax"], calls["torch"]):
        np.testing.assert_allclose(ts, js, atol=1e-5)
        np.testing.assert_allclose(tr, jr, atol=1e-5)
    assert any(len(h) == 3 for h in tt.track_history.values())  # histories filled


# ------------------------------------------------------------ evaluators

def _track_frames(seed=0, n_frames=6):
    """Per frame: tracks with ids (an id switch, a false positive, a
    miss), GT with ids, labels and difficulty."""
    rs = np.random.RandomState(seed)
    frames = []
    for f in range(n_frames):
        gt = np.zeros((4, 9))
        gt[:, :2] = np.array([[0, 0], [10, 0], [0, 10], [20, 20]]) + f * 0.5
        gt[:, 3:6] = [4.0, 2.0, 1.6]
        gt[:, 8] = 0.1 * f
        labels = np.array([1, 1, 2, 3])
        ids = np.array([5, 6, 7, 8])
        tracks = []
        for i in range(4):
            if f == 3 and i == 3:
                continue  # a miss
            box = gt[i].copy()
            box[:2] += rs.randn(2) * 0.2
            tid = 100 + i if not (f >= 4 and i == 1) else 200  # an id switch
            tracks.append(dict(translation=box[:3].tolist(), tracking_id=tid, label=labels[i] - 1,
                               box=box, score=float(rs.uniform(0.3, 1.0))))
        tracks.append(dict(translation=[40.0, 40.0, 0.0], tracking_id=300, label=0,
                           box=np.array([40.0, 40, 0, 4, 2, 1.6, 0, 0, 0]), score=0.2))
        frames.append(dict(tracks=tracks, gt=gt, labels=labels, ids=ids,
                           difficulty=np.array([1, 2, 1, 1], np.int8)))
    return frames


def test_mot_accumulator_and_official_metric_match(jit_reference_iou):
    frames = _track_frames()
    thr = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}
    jw, tw = JWT.WaymoTrackingMetric(CLASSES, thr), TWT.WaymoTrackingMetric(CLASSES, thr)
    for c in range(3):
        ja, ta = JTE.MOTAccumulator(), TTE.MOTAccumulator()
        for f in frames:
            trk = [t for t in f["tracks"] if t["label"] == c]
            args = (np.asarray([t["translation"][:2] for t in trk]).reshape(-1, 2),
                    np.asarray([t["tracking_id"] for t in trk]), f["gt"][f["labels"] == c + 1, :2],
                    f["ids"][f["labels"] == c + 1])
            ja.add_frame(*args)
            ta.add_frame(*args)
        assert ta.summarize() == ja.summarize()
    for f in frames:
        pb = np.asarray([np.r_[t["box"][:6], t["box"][-1:]] for t in f["tracks"]])
        args = ("s0", pb, [t["score"] for t in f["tracks"]],
                [t["label"] + 1 for t in f["tracks"]], [t["tracking_id"] for t in f["tracks"]],
                np.c_[f["gt"][:, :6], f["gt"][:, -1:]], f["labels"], f["ids"], f["difficulty"])
        jw.add_frame(*args)
        tw.add_frame(*args)
    want, got = jw.compute(), tw.compute()
    assert set(got) == set(want)
    for key in want:
        _assert_results_equal(got[key], want[key])
    assert want["VEHICLE_L2"]["mismatch"] > 0 and want["CYCLIST_L2"]["miss"] > 0


@pytest.mark.parametrize("case", [
    "test_perfect_tracking_mota_1", "test_id_switch_detected", "test_fp_fn_counting",
    "test_official_perfect_tracking", "test_official_id_switch_is_mismatch",
    "test_official_cutoff_sweep_drops_low_score_fps", "test_official_l1_ignores_difficulty2",
    "test_official_iou_matching_not_center_distance"])
def test_efg_tpu_metric_cases_on_the_port(case, monkeypatch):
    """efg_tpu's own hand-traced tracking metric cases
    (`tests/test_tracking_eval.py`), run on the port's copies."""
    import test_tracking_eval as cases

    monkeypatch.setattr(cases, "MOTAccumulator", TTE.MOTAccumulator)
    monkeypatch.setattr(JWT, "WaymoTrackingMetric", TWT.WaymoTrackingMetric)
    getattr(cases, case)()


def _evaluator_inputs(frames, seed=0):
    """The raw fixed-shape detections `det_predict` gives, a frame a batch
    (efg_tpu's layout), from the items' noisy detection boxes."""
    out = []
    rs = np.random.RandomState(seed)
    for data, info in frames:
        a = info["annotations"]
        n = len(a["det_boxes"])
        box3d = np.zeros((1, 8, 9), np.float32)
        box3d[0, :n] = a["det_boxes"]
        valid = np.zeros((1, 8), bool)
        valid[0, :n] = True
        labels = np.zeros((1, 8), np.int32)
        labels[0, :n] = a["labels"]
        scores = np.zeros((1, 8), np.float32)
        scores[0, :n] = rs.uniform(0.2, 1.0, n)
        out.append(({"annotations": [a], "metadata": [info["metadata"]]},
                    dict(box3d=box3d, scores=scores, labels=labels, valid=valid)))
    return out


def test_tracking_evaluator_matches(jit_reference_iou):
    """`TrackingEvaluator` on the same detections: its internal greedy
    tracker, CLEAR-MOT and the official-protocol metric give equal
    results; the GT tracks themselves read MOTA 1 exactly."""
    frames = _synthetic_frames()
    cfg = JConfiguration(config_file=SYNTH).get_config()
    tcfg = Configuration(config_file=SYNTH).get_config()
    jev, tev = JTE.TrackingEvaluator(cfg, None), TTE.TrackingEvaluator(tcfg, None)
    for ev in (jev, tev):
        ev.reset()
    for inputs, outputs in _evaluator_inputs(frames):
        jev.process(inputs, outputs)
        tev.process(inputs, outputs)
    want = jev.evaluate()
    _assert_results_equal(tev.evaluate(), want)
    assert 0 < want["tracking/MOTA"] <= 1 and "tracking_official/MOTA_L2" in want

    perfect = TTE.TrackingEvaluator(tcfg, None)
    perfect.reset()
    for data, info in frames:
        a = info["annotations"]
        tracks = [dict(translation=b[:3].tolist(), tracking_id=int(i), label=int(lb) - 1, box=b,
                       score=1.0) for b, i, lb in zip(a["gt_boxes"], a["track_ids"], a["labels"])]
        perfect.process({"annotations": [a], "metadata": [info["metadata"]]},
                        dict(tracks=[tracks]))
    res = perfect.evaluate()
    assert res["tracking/MOTA"] == 1.0 and res["tracking_official/MOTA_L2"] == 1.0


# ----------------------------------------------- the experiment's trainer

OPTS = ["trainer.evaluators=", "trainer.log_interval=1", "trainer.window_size=1",
        "trainer.checkpoint_period=1000000"]
ITERS = 3
# step 1 at f32 rounding; steps 2-3 after AdamW's first, sign-like update
LOSS_TOL = {False: 1e-5, True: 1e-3}


def test_cli_train_matches_efg_tpu_trainer(tmp_path, tmp_path_factory, request, monkeypatch):
    """efg_tpu's DefaultTrainer trains the experiment 3 iterations (its
    20-iteration schedule) in a one-device subprocess; the port's CLI
    trains it from the same initial weights (a step-0 checkpoint of them,
    resumed) on its own loader's batches: the losses and the learning rate
    of the 3 steps agree."""
    from efg_tpu_torch.cli import main as cli

    from test_torch_trainer_parity import _records, jax_trainer_output

    jax_dir = jax_trainer_output(tmp_path_factory, request.config, name="efg_tpu_tracking_parity",
                                 config_path=SYNTH, opts=OPTS, iters=ITERS)
    info = json.loads((jax_dir / "info.json").read_text())
    assert info == {"mesh": {"data": 1, "model": 1}, "step": ITERS, "max_iters": 20}
    with open(jax_dir / "variables.pkl", "rb") as f:
        variables = pickle.load(f)

    monkeypatch.setenv("EFG_CACHE_DIR", str(tmp_path))
    cfg = Configuration(config_file=SYNTH, opts=list(OPTS)).get_config()
    md = cli.load_experiment_module(SYNTH).build_model(cfg, device="cpu")
    sd = flax_to_state_dict(md.module, variables)
    names = [n for n, _ in md.module.named_parameters()]
    out = tmp_path / "EFG_torch" / cli.experiment_relpath(SYNTH)
    out.mkdir(parents=True)
    zeros = {n: torch.zeros_like(sd[n]) for n in names}
    torch.save({"model": sd, "optimizer": {"count": 0, "mu": zeros, "nu": zeros}, "step": 0},
               out / "model_0000000")
    argv = ["--config", SYNTH, "--device", "cpu", "--resume", "task=train", *OPTS]
    # the run stops after ITERS steps of the experiment's own schedule
    from efg_tpu_torch.engine import trainer as T

    monkeypatch.setattr(T, "build_trainer", _cut_trainer(T.build_trainer, ITERS))
    assert cli.main(argv) == 0
    want = _records(jax_dir / "metrics.json")
    got = _records(out / "metrics.json")
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] == list(range(ITERS + 1))
    for it in range(1, ITERS + 1):
        w, g = want[it], got[it]
        for k in ("loss", "loss_cls", "loss_reg", "num_pos", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=LOSS_TOL[it > 1], abs=1e-7), (it, k, g[k], w[k])
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert want[1]["num_pos"] > 0


def _cut_trainer(build, iters):
    """build_trainer whose trainer keeps the config's schedule and stops
    after `iters` steps."""

    def cut(*args, **kwargs):
        trainer = build(*args, **kwargs)
        trainer.max_iters = iters
        return trainer

    return cut
