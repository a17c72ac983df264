"""The port's evaluation pieces against efg_tpu's on the same numpy inputs:
`iou_3d`, both Waymo metric cores (greedy `det3d_metrics` and official
`waymo_official`), `WaymoDetEvaluator`, and the hand-traced fixtures of
efg_tpu's own metric tests run against the port's copies.

Tolerances: `iou_3d` to 1e-5 absolute (both compute in f32, in different
orders); metric results equal to 1e-9 with NaN where efg_tpu has NaN
(the cores count matches in integers and sum heading accuracies in f64,
so equal matches give equal results).

efg_tpu's `iou_3d` runs under `jax.jit` here, on boxes padded to 16 rows:
run eagerly it takes 7 s for each new shape on the CPU. Each pair's IoU is
computed on its own, so the padding rows change no entry."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from efg_tpu.evaluator import det3d_metrics as JD
from efg_tpu.evaluator import waymo_evaluator as JWE
from efg_tpu.evaluator import waymo_official as JWO
from efg_tpu.ops.iou_rotated import iou_3d as jax_iou_3d
from efg_tpu_torch.evaluator import build as B
from efg_tpu_torch.evaluator import det3d_metrics as D
from efg_tpu_torch.evaluator import waymo_evaluator as WE
from efg_tpu_torch.evaluator import waymo_official as WO
from efg_tpu_torch.evaluator.evaluator import DatasetEvaluator, DatasetEvaluators
from efg_tpu_torch.ops.iou_rotated import iou_3d

CLASSES = ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
THR = {"VEHICLE": 0.7, "PEDESTRIAN": 0.5, "CYCLIST": 0.5}
_JIT_IOU = jax.jit(jax_iou_3d)
PAD_ROWS = 16


def _pad(boxes):
    """Rows up to a multiple of PAD_ROWS with 1 m cubes 1 km away."""
    n = len(boxes)
    far = np.zeros((-(-max(n, 1) // PAD_ROWS) * PAD_ROWS - n, 7), np.float32)
    far[:, 0] = 1e3 + 10.0 * np.arange(len(far))
    far[:, 3:6] = 1.0
    return np.concatenate([np.asarray(boxes, np.float32)[:, :7], far])


def jax_iou(a, b):
    """efg_tpu's `iou_3d` [N, M] under jit on padded boxes."""
    return np.asarray(_JIT_IOU(jnp.asarray(_pad(a)), jnp.asarray(_pad(b))))[:len(a), :len(b)]


@pytest.fixture
def jit_reference_iou(monkeypatch):
    """efg_tpu's metric cores with their IoU matrix through `jax_iou`
    (the same function as their `_bev_iou_matrix`, jitted)."""
    def bev_iou_matrix(pred, gt):
        if pred.shape[0] == 0 or gt.shape[0] == 0:
            return np.zeros((pred.shape[0], gt.shape[0]), np.float32)
        return jax_iou(pred, gt)

    monkeypatch.setattr(JD, "_bev_iou_matrix", bev_iou_matrix)
    monkeypatch.setattr(JWO, "_bev_iou_matrix", bev_iou_matrix)


# --------------------------------------------------------------------- iou_3d

def _rand_boxes(rs, n, spread=4.0):
    """[n, 7] boxes (x, y, z, dx, dy, dz, yaw) close enough to overlap."""
    return np.column_stack([
        rs.uniform(-spread, spread, (n, 2)), rs.uniform(-0.5, 0.5, n),
        rs.uniform(1.0, 5.0, n), rs.uniform(0.8, 2.5, n), rs.uniform(1.0, 2.0, n),
        rs.uniform(-np.pi, np.pi, n)]).astype(np.float32)


def _box(x, y, z=0.0, dx=2.0, dy=2.0, dz=2.0, yaw=0.0):
    return [x, y, z, dx, dy, dz, yaw]


def _iou_case(name):
    rs = np.random.RandomState(11)
    if name == "random":
        return _rand_boxes(rs, 12), _rand_boxes(rs, 9)
    if name == "identical":
        a = _rand_boxes(rs, 6)
        return a, a.copy()
    if name == "disjoint":
        a = _rand_boxes(rs, 5)
        b = _rand_boxes(rs, 4)
        b[:, 0] += 100.0
        return a, b
    if name == "edge_touching":  # shared edges and a shared corner, yaw 0 and π/2
        a = [_box(0, 0), _box(0, 0, dx=4.0, dy=1.0), _box(5, 5, yaw=np.pi / 2)]
        b = [_box(2, 0), _box(0, 2), _box(2, 2), _box(4, 0, dx=4.0, dy=1.0), _box(7, 5)]
        return np.array(a, np.float32), np.array(b, np.float32)
    if name == "rotation_90":  # squares invariant, rectangles crossing
        a = [_box(0, 0), _box(0, 0, dx=4.0, dy=1.0), _box(1, 1, dx=3.0, dy=1.5, yaw=0.3)]
        b = [_box(0, 0, yaw=np.pi / 2), _box(0, 0, dx=4.0, dy=1.0, yaw=np.pi / 2),
             _box(1, 1, dx=3.0, dy=1.5, yaw=0.3 + np.pi / 2)]
        return np.array(a, np.float32), np.array(b, np.float32)
    if name == "zero_z_overlap":  # same footprint; z apart by the height, and more
        a = _rand_boxes(rs, 4)
        b = a.copy()
        b[:2, 2] += a[:2, 5] / 2 + b[:2, 5] / 2
        b[2:, 2] -= 10.0
        return a, b
    raise KeyError(name)


IOU_CASES = ["random", "identical", "disjoint", "edge_touching", "rotation_90", "zero_z_overlap"]


@pytest.mark.parametrize("case", IOU_CASES)
def test_iou_3d_matches_efg_tpu(case):
    a, b = _iou_case(case)
    want = jax_iou(a, b)
    got = iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (len(a), len(b))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "identical":
        np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    if case in ("disjoint", "zero_z_overlap"):
        assert np.abs(got).max() <= 1e-5
    if case == "rotation_90":
        np.testing.assert_allclose(got[0, 0], 1.0, atol=1e-5)  # a square
        np.testing.assert_allclose(got[1, 1], 1.0 / 7.0, atol=1e-5)  # a 4×1 cross
    if case == "random":
        assert (got > 0.05).sum() >= 5  # the case does overlap


def test_bev_iou_matrix_matches_efg_tpu():
    rs = np.random.RandomState(3)
    a, b = _rand_boxes(rs, 7), _rand_boxes(rs, 5)
    np.testing.assert_allclose(D._bev_iou_matrix(a.astype(np.float64), b), jax_iou(a, b),
                               atol=1e-5)
    assert D._bev_iou_matrix(a, b).dtype == np.float32
    for n, m in ((0, 5), (7, 0)):
        assert D._bev_iou_matrix(a[:n], b[:m]).shape == (n, m)


# ------------------------------------------------------------ metric cores

def _frames(seed=5, n_frames=10):
    """Frames of 7-column boxes for a calculator's `add_frame`: GTs of
    every class with difficulty 1 or 2 and some with fewer than 5 points
    (both L1-excluded), predictions that copy GTs with jitter and heading
    errors, false positives, a frame without predictions and one without
    GT."""
    rs = np.random.RandomState(seed)
    frames = []
    for f in range(n_frames):
        m = 0 if f == 3 else rs.randint(1, 7)
        gt = _rand_boxes(rs, m, spread=25.0)
        gl = rs.randint(1, 4, m)
        diff = rs.choice([1, 2], m, p=[0.7, 0.3])
        npts = rs.choice([2, 5, 50, 300], m, p=[0.15, 0.15, 0.35, 0.35])
        preds, labels = [], []
        for j in range(m):
            if rs.rand() < 0.8:
                p = gt[j].copy()
                p[:2] += rs.randn(2) * 0.15
                p[3:6] *= 1 + rs.randn(3) * 0.05
                p[6] += rs.choice([0.0, rs.randn() * 0.4, np.pi, np.pi / 2])
                preds.append(p)
                labels.append(gl[j] if rs.rand() < 0.9 else rs.randint(1, 4))
        n_fp = rs.randint(0, 4)
        if n_fp:
            preds.extend(_rand_boxes(rs, n_fp, spread=25.0))
            labels.extend(rs.randint(1, 4, n_fp))
        if f == 6:
            preds, labels = [], []
        pb = np.asarray(preds, np.float32).reshape(-1, 7)
        ps = rs.uniform(0.05, 0.99, len(pb)).astype(np.float32)
        frames.append(dict(pred_boxes=pb, pred_scores=ps, pred_labels=np.asarray(labels, np.int64),
                           gt_boxes=gt, gt_labels=gl.astype(np.int64),
                           gt_difficulty=diff.astype(np.int64), gt_num_points=npts))
    return frames


def assert_results_equal(got, want, atol=1e-9):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if np.isnan(w):
            assert np.isnan(g), (k, g, w)
        else:
            assert g == pytest.approx(w, abs=atol), (k, g, w)


CORES = {"greedy": (D.DetectionAPCalculator, JD.DetectionAPCalculator),
         "official": (WO.WaymoOfficialCalculator, JWO.WaymoOfficialCalculator)}


@pytest.mark.parametrize("core", sorted(CORES))
def test_calculator_matches_efg_tpu(core, jit_reference_iou):
    port_cls, jax_cls = CORES[core]
    port, ref = port_cls(CLASSES, THR), jax_cls(CLASSES, THR)
    frames = _frames()
    assert any(len(f["pred_boxes"]) == 0 for f in frames)
    assert any(len(f["gt_boxes"]) == 0 for f in frames)
    for f in frames:
        port.add_frame(**f)
        ref.add_frame(**f)
    got, want = port.compute(), ref.compute()
    assert_results_equal(got, want)
    finite = [v for v in want.values() if np.isfinite(v)]
    assert len(finite) >= 9 and len(set(np.round(finite, 6))) >= 4  # not a degenerate case
    assert any(got[f"{c}/L2/APH"] < got[f"{c}/L2/AP"] for c in CLASSES)  # heading errors
    assert any(got[f"{c}/L1/AP"] != got[f"{c}/L2/AP"] for c in CLASSES)  # L1 excludes


# ------------------------------------------- hand-traced fixtures, port copies
# Each fixture is one of efg_tpu's Waymo metric tests (tests/test_metric_golden.py,
# tests/test_waymo_official.py, tests/test_det3d_eval.py), its expected values
# derived by hand or by an independent brute force, run on the port's modules.

def _sq(x, y, yaw=0.0):
    """2×2×2 square-footprint box (yaw-invariant BEV footprint)."""
    return [x, y, 0.0, 2.0, 2.0, 2.0, yaw]


def _fx_compute_ap_constant_precision():
    r = np.linspace(1.0, 0.0, 41)
    assert WO.compute_ap(np.full(41, 0.8), r) == pytest.approx(0.8, abs=1e-9)


def _fx_compute_ap_single_point_conservative_fill():
    assert WO.compute_ap(np.array([0.5]), np.array([1.0])) == pytest.approx(0.5, abs=1e-9)


def _fx_compute_ap_envelope_step():
    r = np.linspace(1.0, 0.0, 41)
    p = np.where(r > 0.5, 0.2, 1.0)
    assert WO.compute_ap(p, r) == pytest.approx(0.6, abs=1e-9)


def _fx_compute_ap_known_values():
    p = np.ones(WO.NUM_CUTOFFS)
    r = np.linspace(1, 0, WO.NUM_CUTOFFS)
    assert WO.compute_ap(p, r) == pytest.approx(1.0)
    assert WO.compute_ap(p * 0.5, r) == pytest.approx(0.5)
    p2, r2 = np.zeros(WO.NUM_CUTOFFS), np.zeros(WO.NUM_CUTOFFS)
    p2[0] = r2[0] = 1.0
    assert 0.0 < WO.compute_ap(p2, r2) <= 1.0


def _fx_official_accumulator_hand_traced():
    """2 GT, 3 preds: exact match (s=.905), a π/2 heading error (IoU 1,
    hacc 0.5, s=.655), a far FP (s=.355): AP 1.0, APH 0.8875 (traced by
    hand in tests/test_metric_golden.py)."""
    acc = WO.OfficialAccumulator(iou_threshold=0.7, level=1)
    preds = np.array([_sq(0, 0), _sq(20, 0, yaw=np.pi / 2), _sq(40, 0)], np.float64)
    gts = np.array([_sq(0, 0), _sq(20, 0)], np.float64)
    acc.add_frame(preds, np.array([0.905, 0.655, 0.355]), gts, np.ones(2, bool))
    ci = {c: i for i, c in enumerate(np.round(acc.cutoffs, 2))}
    for c, (tp, fp, h) in {0.00: (2, 1, 1.5), 0.35: (2, 1, 1.5), 0.36: (2, 0, 1.5),
                           0.65: (2, 0, 1.5), 0.66: (1, 0, 1.0), 0.90: (1, 0, 1.0),
                           0.91: (0, 0, 0.0), 1.00: (0, 0, 0.0)}.items():
        i = ci[c]
        assert acc.tp[i] == tp and acc.fp[i] == fp, c
        assert acc.hsum[i] == pytest.approx(h, abs=1e-12), c
        assert acc.fn[i] == 2 - tp, c
    res = acc.compute()
    assert res["AP"] == pytest.approx(1.0, abs=1e-9)
    assert res["APH"] == pytest.approx(0.8875, abs=1e-9)


def _fx_official_calculator_l2_ignored_prediction():
    calc = WO.WaymoOfficialCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    calc.add_frame(pred_boxes=np.array([_sq(0, 0)], np.float64), pred_scores=np.array([0.505]),
                   pred_labels=np.array([1]), gt_boxes=np.array([_sq(0, 0)], np.float64),
                   gt_labels=np.array([1]), gt_difficulty=np.array([2]))
    out = calc.compute()
    assert np.isnan(out["VEHICLE/L1/AP"])
    assert out["VEHICLE/L2/AP"] == pytest.approx(1.0, abs=1e-9)
    l1 = calc.cells[("VEHICLE", "L1")]
    assert l1.fp.sum() == 0 and l1.tp.sum() == 0


def _brute_max_weight(iou, thr):
    """Exhaustive maximum-total-IoU matching over IoU ≥ thr pairs."""
    n, m = iou.shape
    best = -1.0
    for k in range(0, min(n, m) + 1):
        for ps in itertools.permutations(range(n), k):
            for gs in itertools.combinations(range(m), k):
                if all(iou[a, b] >= thr for a, b in zip(ps, gs)):
                    best = max(best, sum(iou[a, b] for a, b in zip(ps, gs)))
    return best


def _fx_hungarian_match_is_max_weight():
    rs = np.random.RandomState(0)
    for trial in range(30):
        n, m = rs.randint(0, 5), rs.randint(0, 5)
        iou = rs.uniform(0, 1, (n, m))
        match = WO.hungarian_match(iou, 0.3)
        used = [match[j] for j in range(m) if match[j] >= 0]
        assert len(used) == len(set(used))
        assert all(iou[match[j], j] >= 0.3 for j in range(m) if match[j] >= 0)
        got_w = sum(iou[match[j], j] for j in range(m) if match[j] >= 0)
        assert got_w >= _brute_max_weight(iou, 0.3) - 1e-9, trial


def _fx_accumulator_matches_slow_spec():
    """The accumulator against a direct reading of the spec: a full-matrix
    Hungarian matching at every cutoff (tests/test_waymo_official.py)."""
    rs = np.random.RandomState(1)
    thr = 0.5
    fast = WO.OfficialAccumulator(thr, 2)
    tp, fp, fn, hsum = (np.zeros(WO.NUM_CUTOFFS) for _ in range(4))
    for _ in range(6):
        m, n = rs.randint(0, 6), rs.randint(0, 8)
        gb = np.zeros((m, 7), np.float32)
        gb[:, :2] = rs.uniform(-20, 20, (m, 2))
        gb[:, 2] = 0.5
        gb[:, 3:6] = rs.uniform(2, 5, (m, 3))
        gb[:, 6] = rs.uniform(-np.pi, np.pi, m)
        pb = np.zeros((n, 7), np.float32)
        for i in range(n):
            if m and rs.rand() < 0.7:
                j = rs.randint(m)
                pb[i] = gb[j]
                pb[i, :2] += rs.randn(2) * 0.5
                pb[i, 6] += rs.randn() * 0.3
            else:
                pb[i, :2] = rs.uniform(-20, 20, 2)
                pb[i, 3:6] = rs.uniform(2, 5, 3)
        ps = rs.uniform(0, 1, n).astype(np.float32)
        inc = rs.rand(m) < 0.8
        order = np.argsort(-ps, kind="stable")
        pb, ps = pb[order], ps[order]
        iou = D._bev_iou_matrix(pb, gb) if n and m else np.zeros((n, m))
        fast.add_frame(pb, ps, gb, inc)
        for ci, c in enumerate(WO.score_cutoffs()):
            keep = ps >= c
            sub = iou[keep]
            kept = np.nonzero(keep)[0]
            match = np.full(m, -1, np.int64)
            if sub.shape[0] and m:
                w = np.where(sub >= thr, sub, 0.0)
                for a, b in zip(*linear_sum_assignment(-w)):
                    if w[a, b] > 0:
                        match[b] = a
            t, h, ignored = 0, 0.0, set()
            for j in range(m):
                if match[j] >= 0:
                    if inc[j]:
                        t += 1
                        d = abs(pb[kept[match[j]], 6] - gb[j, 6]) % (2 * np.pi)
                        h += max(0.0, 1 - min(d, 2 * np.pi - d) / np.pi)
                    else:
                        ignored.add(match[j])
            tp[ci] += t
            fp[ci] += sub.shape[0] - t - len(ignored)
            fn[ci] += int(inc.sum()) - t
            hsum[ci] += h
    np.testing.assert_allclose(fast.tp, tp)
    np.testing.assert_allclose(fast.fp, fp)
    np.testing.assert_allclose(fast.fn, fn)
    np.testing.assert_allclose(fast.hsum, hsum, atol=1e-6)


def _gt_boxes(rs, m):
    gb = np.zeros((m, 7), np.float32)
    gb[:, :2] = rs.uniform(-30, 30, (m, 2))
    gb[:, 3:6] = rs.uniform(3, 5, (m, 3))
    gb[:, 6] = rs.uniform(-np.pi, np.pi, m)
    return gb


def _fx_official_calculator_perfect_predictions():
    rs = np.random.RandomState(3)
    calc = WO.WaymoOfficialCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    for _ in range(4):
        gb = _gt_boxes(rs, 5)
        calc.add_frame(gb, np.full(5, 0.9, np.float32), np.ones(5, np.int64), gb,
                       np.ones(5, np.int64))
    res = calc.compute()
    assert res["VEHICLE/L2/AP"] == pytest.approx(1.0, abs=1e-6)
    assert res["VEHICLE/L2/APH"] == pytest.approx(1.0, abs=1e-6)


def _fx_official_calculator_l1_ignores_hard_matches():
    gb = np.array([[0, 0, 0, 4, 4, 2, 0.0]], np.float32)
    calc = WO.WaymoOfficialCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    calc.add_frame(gb, np.array([0.9], np.float32), np.array([1]), gb, np.array([1]),
                   gt_difficulty=np.array([2]))
    res = calc.compute()
    assert np.isnan(res["VEHICLE/L1/AP"])
    assert res["VEHICLE/L2/AP"] == pytest.approx(1.0, abs=1e-6)


def _boxes(rs, n, spread=30.0):
    return np.column_stack(
        [rs.uniform(-spread, spread, (n, 2)), rs.uniform(-1, 1, n),
         rs.uniform(3, 5, n), rs.uniform(1.5, 2.5, n), rs.uniform(1.2, 2.0, n),
         rs.uniform(-np.pi, np.pi, n)]).astype(np.float32)


def _fx_heading_accuracy():
    for ha in (D._heading_accuracy, WO._heading_accuracy):
        assert ha(np.array(0.0), np.array(0.0)) == pytest.approx(1.0)
        assert ha(np.array(0.0), np.array(np.pi)) == pytest.approx(0.0)
        assert ha(np.array(0.0), np.array(np.pi / 2)) == pytest.approx(0.5)
        assert ha(np.array(-np.pi + 0.01), np.array(np.pi - 0.01)) > 0.99


def _fx_greedy_perfect_detections_ap1():
    calc = D.DetectionAPCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    rs = np.random.RandomState(0)
    for _ in range(4):
        gt = _boxes(rs, 5)
        calc.add_frame(gt, np.ones(5) * 0.9, np.ones(5, np.int64), gt, np.ones(5, np.int64))
    res = calc.compute()
    assert res["VEHICLE/L2/AP"] == pytest.approx(1.0)
    assert res["VEHICLE/L2/APH"] == pytest.approx(1.0)


def _fx_greedy_heading_errors_reduce_aph_not_ap():
    calc = D.DetectionAPCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    gt = _boxes(np.random.RandomState(1), 6)
    pred = gt.copy()
    pred[:, -1] += np.pi
    calc.add_frame(pred, np.ones(6) * 0.9, np.ones(6, np.int64), gt, np.ones(6, np.int64))
    res = calc.compute()
    assert res["VEHICLE/L2/AP"] == pytest.approx(1.0)
    assert res["VEHICLE/L2/APH"] == pytest.approx(0.0, abs=1e-6)


def _fx_greedy_l1_l2_difficulty_split():
    calc = D.DetectionAPCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    gt = _boxes(np.random.RandomState(2), 4)
    calc.add_frame(gt[:2], np.ones(2) * 0.9, np.ones(2, np.int64), gt, np.ones(4, np.int64),
                   np.array([0, 0, 2, 2], np.int64), np.full(4, 100))
    res = calc.compute()
    assert res["VEHICLE/L1/AP"] == pytest.approx(1.0)
    assert res["VEHICLE/L2/AP"] == pytest.approx(0.5, abs=0.01)


def _fx_greedy_false_positives_lower_ap():
    calc = D.DetectionAPCalculator(["VEHICLE"], {"VEHICLE": 0.7})
    rs = np.random.RandomState(3)
    gt = _boxes(rs, 3)
    pred = np.concatenate([gt, _boxes(rs, 3, spread=200.0)])
    scores = np.array([0.9, 0.9, 0.9, 0.95, 0.95, 0.95])
    calc.add_frame(pred, scores, np.ones(6, np.int64), gt, np.ones(3, np.int64))
    assert calc.compute()["VEHICLE/L2/AP"] < 0.6


FIXTURES = {name[len("_fx_"):]: fn for name, fn in sorted(globals().items())
            if name.startswith("_fx_")}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_hand_traced_fixture_on_port(fixture):
    FIXTURES[fixture]()


# --------------------------------------------------------- WaymoDetEvaluator

class _Cfg(dict):
    __getattr__ = dict.__getitem__


def _config(core):
    return _Cfg(dataset=_Cfg(classes=CLASSES), trainer=_Cfg(waymo_metric=core))


def _host_batch(frames, k=12):
    """A host batch (annotations with 9-column GT boxes and velocity) and
    fixed-shape [B, K] outputs, as the loader and the eval step give them."""
    annotations, box3d, scores, labels, valid = [], [], [], [], []
    rs = np.random.RandomState(9)
    for f in frames:
        gt9 = np.zeros((len(f["gt_boxes"]), 9), np.float32)
        gt9[:, :6], gt9[:, 8] = f["gt_boxes"][:, :6], f["gt_boxes"][:, 6]
        gt9[:, 6:8] = rs.randn(len(gt9), 2)
        annotations.append({"gt_boxes": gt9, "labels": f["gt_labels"],
                            "gt_names": np.array([CLASSES[i - 1] for i in f["gt_labels"]]),
                            "difficulty": f["gt_difficulty"].astype(np.int8),
                            "num_points_in_gt": f["gt_num_points"]})
        n = min(len(f["pred_boxes"]), k)
        b = np.zeros((k, 9), np.float32)
        b[:n, :6], b[:n, 8] = f["pred_boxes"][:n, :6], f["pred_boxes"][:n, 6]
        b[:n, 6:8] = rs.randn(n, 2)
        box3d.append(b)
        scores.append(np.pad(f["pred_scores"][:n], (0, k - n)))
        labels.append(np.pad(f["pred_labels"][:n], (0, k - n)).astype(np.int32))
        valid.append(np.arange(k) < n)
    outputs = dict(box3d=np.stack(box3d), scores=np.stack(scores), labels=np.stack(labels),
                   valid=np.stack(valid))
    return {"annotations": annotations}, outputs


@pytest.mark.parametrize("core", sorted(CORES))
def test_waymo_det_evaluator_matches_efg_tpu(core, jit_reference_iou):
    frames = _frames(seed=8, n_frames=8)
    results = []
    for cls in (WE.WaymoDetEvaluator, JWE.WaymoDetEvaluator):
        ev = cls(_config(core), None)
        ev.reset()
        for b0 in range(0, len(frames), 4):
            ev.process(*_host_batch(frames[b0:b0 + 4]))
        results.append(ev.evaluate())
    got, want = results
    assert set(got) == set(want) == {f"waymo/{c}/{lvl}/{m}" for c in CLASSES
                                     for lvl in ("L1", "L2") for m in ("AP", "APH")} \
        | {"waymo/mAPH/L2"}
    assert_results_equal(got, want)
    assert 0.0 < got["waymo/mAPH/L2"] < 1.0


def test_waymo_det_evaluator_core_switch_and_reset():
    assert isinstance(WE.WaymoDetEvaluator(_config("official"), None).calc,
                      WO.WaymoOfficialCalculator)
    assert isinstance(WE.WaymoDetEvaluator(_Cfg(dataset=_Cfg(classes=CLASSES), trainer=_Cfg()),
                                           None).calc, WO.WaymoOfficialCalculator)
    ev = WE.WaymoDetEvaluator(_config("greedy"), None)
    assert isinstance(ev.calc, D.DetectionAPCalculator)
    with pytest.raises(ValueError, match="waymo_metric"):
        WE.WaymoDetEvaluator(_config("hungarian"), None)
    batch, outputs = _host_batch(_frames(seed=2, n_frames=2))
    ev.process(batch, outputs)
    first = ev.evaluate()
    ev.reset()
    ev.process(batch, outputs)
    assert_results_equal(ev.evaluate(), first, atol=0)


def test_dataset_evaluators_merge_and_registry():
    class A(DatasetEvaluator):
        def evaluate(self):
            return {"a": 1.0}

    class AlsoA(DatasetEvaluator):
        def evaluate(self):
            return {"a": 2.0}

    assert DatasetEvaluators([A(), DatasetEvaluator()]).evaluate() == {"a": 1.0}
    with pytest.raises(AssertionError, match="Duplicate eval key a"):
        DatasetEvaluators([A(), AlsoA()]).evaluate()
    # every evaluator efg_tpu registers, PanopticEvaluator included
    from efg_tpu.evaluator.registry import EVALUATORS as J_EVALUATORS

    assert sorted(k for k, _ in B.EVALUATORS) == sorted(k for k, _ in J_EVALUATORS) == [
        "COCOEvaluator", "PanopticEvaluator", "TrackingEvaluator", "WaymoDetEvaluator",
        "nuScenesDetEvaluator"]
    cfg = _Cfg(dataset=_Cfg(classes=CLASSES), trainer=_Cfg(evaluators=["WaymoDetEvaluator"]))
    evs = B.build_evaluators(cfg, None)
    assert [type(e) for e in evs] == [WE.WaymoDetEvaluator]
    cfg = _Cfg(dataset=_Cfg(classes=CLASSES), trainer=_Cfg(evaluators=["PanopticEvaluator"]))
    (ev,) = B.build_evaluators(cfg, type("DS", (), {"thing_contiguous_ids": {0, 2}})())
    assert type(ev).__name__ == "PanopticEvaluator" and ev.thing_ids == {0, 2}
    with pytest.raises(KeyError, match="NoSuchEvaluator"):
        B.build_evaluators(_Cfg(dataset=_Cfg(classes=CLASSES),
                                trainer=_Cfg(evaluators=["NoSuchEvaluator"])), None)
