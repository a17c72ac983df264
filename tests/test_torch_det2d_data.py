"""Port parity of the 2D data path and COCO evaluation (efg_tpu_torch vs
efg_tpu) on a COCO-format fixture the test writes: `train2017/`,
`val2017/`, `annotations/instances_{train,val}2017.json` and
`person_keypoints_val2017.json`, gapped category ids (1, 3, 7, 13, 90),
PNG images written with cv2 in landscape and portrait, an empty and a
crowd-only image in each split.

The COCO FCOS experiment's config is read as written (its dataset
gallery include resolved through `EFG_PATH`), the data root pointed at
the fixture by the dotlist `detection.source.local.root`, the canvas cut
to 96×128. Checked bit for bit: the items of both splits and of the
keypoints variant under one numpy seed (the processor chains, cv2's
resize included: both packages call it), `aspect_ratios`, the class
mapping, `collate_fixed`'s batch, `DistributedGroupSampler`'s streams and
the train loader's batches over it. `COCOEvaluator` and `COCOEvalNP`
(bbox, segm, keypoints, proposal AR) give efg_tpu's results on the same
detections; perfect detections read AP = 1 exactly.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import efg_tpu.data as JD
import efg_tpu.evaluator  # noqa: F401  (registrations)
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.data import builder as JB
from efg_tpu.data.samplers import dataset_sampler as JS
from efg_tpu.evaluator import coco_eval_np as JNP
from efg_tpu.evaluator.coco_evaluator import COCOEvaluator as JCOCOEvaluator
import efg_tpu_torch.data as TD
import efg_tpu_torch.evaluator  # noqa: F401  (registrations)
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data import builder as TB
from efg_tpu_torch.data.image_io import read_image
from efg_tpu_torch.data.samplers import dataset_sampler as TS
from efg_tpu_torch.evaluator import coco_eval_np as TNP
from efg_tpu_torch.evaluator.coco_evaluator import COCOEvaluator as TCOCOEvaluator

from test_torch_data import _equal

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "playground/detection.2d/coco/fcos/fcos.res50.fpn.coco.800size.1x/config.yaml")
CATEGORIES = [(1, "person"), (3, "car"), (7, "train"), (13, "stop sign"), (90, "toothbrush")]
TRAIN_SIZES = [(48, 64), (64, 48), (40, 60), (60, 40), (48, 64), (64, 48), (52, 70), (70, 52)]
VAL_SIZES = [(48, 64), (64, 48), (40, 60), (60, 40)]


def _small(root):
    """Dotlists: the fixture's root, a 96×128 canvas, two short-edge sizes
    (up- and down-scaling), a seed."""
    out = [f"detection.source.local.root={root}", "misc.seed=3"]
    for split, i in (("train", 3), ("val", 2)):
        out += [f"dataset.processors.{split}[{i}].PadImage.height=96",
                f"dataset.processors.{split}[{i}].PadImage.width=128",
                f"dataset.processors.{split}[0].ResizeShortestEdge.max_size=120"]
    out.append("dataset.processors.train[0].ResizeShortestEdge.short_edge_length=[36,80]")
    out.append("dataset.processors.val[0].ResizeShortestEdge.short_edge_length=72")
    return out


def write_coco(root, split, sizes, seed, keypoints=False):
    """A COCO split under `root`: PNG images and its annotation JSON. The
    last two images hold no annotation and only crowd ones."""
    rs = np.random.RandomState(seed)
    (root / f"{split}2017").mkdir(parents=True, exist_ok=True)
    (root / "annotations").mkdir(exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img_id = 1000 * seed + 7 * i + 1  # ids that are not positions
        name = f"{img_id:012d}.png"
        pixels = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        n = 0 if i == len(sizes) - 2 else rs.randint(1, 5)
        for _ in range(n):
            bw, bh = rs.uniform(6, w * 0.6), rs.uniform(6, h * 0.6)
            x, y = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
            cat = CATEGORIES[rs.randint(len(CATEGORIES))][0] if not keypoints else 1
            crowd = int(i == len(sizes) - 1 or rs.rand() < 0.15)
            pixels[int(y):int(y + bh), int(x):int(x + bw)] = rs.randint(0, 256, 3)
            a = dict(id=len(anns) + 1, image_id=img_id, category_id=cat,
                     bbox=[float(x), float(y), float(bw), float(bh)], area=float(bw * bh * 0.8),
                     iscrowd=crowd)
            if keypoints:
                kp = np.stack([rs.uniform(x, x + bw, 17), rs.uniform(y, y + bh, 17),
                               rs.randint(0, 3, 17)], -1)
                a["keypoints"] = [float(v) for v in kp.reshape(-1)]
                a["num_keypoints"] = int((kp[:, 2] > 0).sum())
            anns.append(a)
        assert cv2.imwrite(str(root / f"{split}2017" / name), pixels)
        images.append(dict(id=img_id, file_name=name, height=h, width=w))
    cats = [dict(id=c, name=n, supercategory="x") for c, n in CATEGORIES]
    json_name = f"person_keypoints_{split}2017.json" if keypoints else f"instances_{split}2017.json"
    with open(root / "annotations" / json_name, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats[::-1]), f)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    write_coco(root, "train", TRAIN_SIZES, 1)
    write_coco(root, "val", VAL_SIZES, 2)
    write_coco(root, "val", VAL_SIZES, 3, keypoints=True)
    return root


@pytest.fixture
def configs(coco_root, monkeypatch):
    monkeypatch.setenv("EFG_PATH", str(ROOT))

    def make(*opts):
        opts = _small(coco_root) + list(opts)
        return (JConfiguration(config_file=CONFIG, opts=list(opts)).get_config(),
                Configuration(config_file=CONFIG, opts=list(opts)).get_config())

    return make


def test_read_image_matches_cv2(coco_root):
    path = sorted((coco_root / "train2017").iterdir())[0]
    got = read_image(str(path))
    want = cv2.imread(str(path)).astype(np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(OSError, match="no such file"):
        read_image(str(coco_root / "missing.png"))
    bad = coco_root / "not_an_image.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(OSError, match="cannot decode"):
        read_image(str(bad))


@pytest.mark.parametrize("split", ["train", "val", "keypoints"])
def test_coco_items_equal(configs, split):
    opts = ["task=val", "detection.source.local.val_json=/annotations/person_keypoints_val2017.json"] \
        if split == "keypoints" else [f"task={split}"]
    jc, tc = configs(*opts)
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    n_all = len(TRAIN_SIZES if split == "train" else VAL_SIZES)
    assert len(jds) == len(tds) == (n_all - 2 if split == "train" else n_all)  # train drops 2
    _equal(jds.aspect_ratios, tds.aspect_ratios, "aspect_ratios")
    assert 0 < tds.aspect_ratios.sum() < len(tds)
    assert jds.cat_id_to_contiguous == tds.cat_id_to_contiguous == {1: 0, 3: 1, 7: 2, 13: 3, 90: 4}
    assert jds.class_names == tds.class_names == [n for _, n in CATEGORIES]
    assert tds.keypoints_on == (split == "keypoints")
    for idx in range(len(tds)):
        for rep in range(2 if split == "train" else 1):
            np.random.seed(100 * idx + rep)
            want = jds[idx]
            np.random.seed(100 * idx + rep)
            got = tds[idx]
            _equal(want, got, f"{split} item {idx}")
    assert got[0]["image"].shape == (96, 128, 3)


def test_collate_group_sampler_and_loader(configs):
    jc, tc = configs("task=train", "dataloader.sampler=DistributedGroupSampler",
                     "dataloader.num_workers=0")
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    items = []
    for idx in (0, 1, 5):
        np.random.seed(idx)
        items.append(tds[idx])
    _equal(JB.collate_fixed(items, 4), TB.collate_fixed(items, 4), "collate max_gt 4")
    batch = TB.collate_fixed(items, 128)
    assert batch["images"].shape == (3, 96, 128, 3) and batch["gt_mask2d"].shape == (3, 128)
    _equal(JB.pad_gt2d(items[0][1]["annotations"], 6), TB.pad_gt2d(items[0][1]["annotations"], 6))

    # the streams: group sizes 3 and 3 (pad ≤ size) and batch 4 (np.resize padding)
    for spb, seed in ((2, 3), (4, 9), (1, None)):
        j = iter(JS.DistributedGroupSampler(len(jds), jds.aspect_ratios, spb, seed=seed))
        t = iter(TS.DistributedGroupSampler(len(tds), tds.aspect_ratios, spb, seed=seed))
        jstream = [next(j) for _ in range(48)]
        assert jstream == [next(t) for _ in range(48)]
        for b in range(0, 48, spb):
            assert len({int(tds.aspect_ratios[i]) for i in jstream[b:b + spb]}) == 1

    jl, tl = JB.build_dataloader(jc, jds, train=True), TB.build_dataloader(tc, tds, train=True)
    assert isinstance(tl.sampler, TS.DistributedGroupSampler)
    for k, (jb, tb) in enumerate(zip(jl, tl)):
        _equal(jb, tb, f"batch {k}")
        if k == 3:
            break


def _detections(batch, seed, perfect=False):
    """Fixed-shape `predict` outputs for a host batch: each GT box jittered
    (or exact), plus false positives, labels mixed in; padded to 20."""
    rs = np.random.RandomState(seed)
    b = len(batch["annotations"])
    out = dict(boxes=np.zeros((b, 20, 4), np.float32), scores=np.zeros((b, 20), np.float32),
               labels=np.full((b, 20), -1, np.int64), valid=np.zeros((b, 20), bool))
    for i, anno in enumerate(batch["annotations"]):
        gt, cls = anno["boxes2d"], anno["classes"]
        rows = [(g, c, 0.9) for g, c in zip(gt, cls)] if perfect else \
            [(g + rs.randn(4) * 2, c, rs.uniform(0.3, 1)) for g, c in zip(gt, cls)] + \
            [(np.sort(rs.uniform(0, 90, 4).reshape(2, 2), 0).T.reshape(-1)[[0, 2, 1, 3]],
              rs.randint(5), rs.uniform(0, 0.5)) for _ in range(3)]
        for k, (box, c, s) in enumerate(rows[:20]):
            out["boxes"][i, k], out["labels"][i, k], out["scores"][i, k] = box, c, s
            out["valid"][i, k] = True
    return out


@pytest.mark.parametrize("perfect", [False, True])
def test_coco_evaluator_matches(configs, perfect):
    jc, tc = configs("task=val", "dataloader.eval_batch_size=3")
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    jev, tev = JCOCOEvaluator(jc, jds), TCOCOEvaluator(tc, tds)
    for ev in (jev, tev):
        ev.reset()
    for k, batch in enumerate(TB.build_dataloader(tc, tds, train=False)):
        out = _detections(batch, k, perfect)
        jev.process(batch, out)
        tev.process(batch, out)
    want, got = jev.evaluate(), tev.evaluate()
    assert set(got) == set(want) and "coco/AP" in got
    for key, w in want.items():
        assert (math.isnan(w) and math.isnan(got[key])) or got[key] == w, (key, got[key], w)
    if perfect:
        assert got["coco/AP"] == got["coco/AP50"] == got["coco/AP75"] == 1.0


def _summaries(evs, iou_type):
    """Each evaluator's summary, or the IndexError it raised."""
    out = []
    for ev in evs:
        try:
            out.append(ev.summarize_proposals(max_dets=(1, 10, 100)) if iou_type == "proposals"
                       else ev.summarize())
        except IndexError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints", "proposals"])
def test_coco_eval_np_matches(iou_type):
    """Random detections of 3 categories on 6 images. Where efg_tpu's core
    raises on a threshold with every detection ignored (queue 3 item 14),
    the port's scores it 0 and the other keys are not compared."""
    rs = np.random.RandomState(4)
    evs = [m.COCOEvalNP(iou_type="bbox" if iou_type == "proposals" else iou_type)
           for m in (JNP, TNP)]
    for img in range(6):
        for cat in range(3):
            # segm / keypoints: numpy cannot reshape an empty mask or
            # keypoint stack to (0, -1, ...), so each image has one of each
            lo = 1 if iou_type in ("segm", "keypoints") else 0
            ng, nd = rs.randint(lo, 5), rs.randint(lo, 7)
            gt = np.concatenate([rs.uniform(0, 60, (ng, 2)), rs.uniform(70, 200, (ng, 2))], 1)
            det = np.concatenate([gt[:nd], rs.uniform(0, 200, (max(nd - ng, 0), 4))])[:nd]
            det = np.concatenate([np.minimum(det[:, :2], det[:, 2:]),
                                  np.maximum(det[:, :2], det[:, 2:])], 1) + rs.randn(nd, 4)
            kw = dict(det_boxes=det, det_scores=rs.uniform(0, 1, nd), gt_boxes=gt,
                      gt_iscrowd=rs.rand(ng) < 0.2, gt_areas=rs.uniform(100, 20000, ng))
            if iou_type == "segm":
                kw["det_masks"] = rs.rand(nd, 16, 16) < 0.5
                kw["gt_masks"] = rs.rand(ng, 16, 16) < 0.5
            if iou_type == "keypoints":
                kw["det_keypoints"] = rs.uniform(0, 200, (nd, 17, 3))
                kw["gt_keypoints"] = np.concatenate(
                    [rs.uniform(0, 200, (ng, 17, 2)), rs.randint(0, 3, (ng, 17, 1))], -1)
            for ev in evs:
                ev.add_image(cat, **kw)
    want, got = _summaries(evs, iou_type)
    assert isinstance(got, dict)
    if isinstance(want, IndexError):
        assert iou_type in ("segm", "keypoints") and all(not math.isnan(v) for k, v in got.items()
                                          if k in ("AP", "AP50", "AR100")), got
        return
    assert set(got) == set(want)
    for key, w in want.items():
        assert (math.isnan(w) and math.isnan(got[key])) or got[key] == w, (key, got[key], w)
    if iou_type != "proposals":
        assert evs[0].per_category_ap() == evs[1].per_category_ap()


def test_coco_eval_np_all_detections_ignored():
    """Queue 3 item 14's witness: one small GT and one large detection
    that misses it. In the `small` range the detection is ignored (out of
    range, unmatched) while the range holds GT: efg_tpu raises IndexError,
    the port scores APs 0 as pycocotools does; the other keys agree."""
    gt = np.array([[0, 0, 10, 10.0]])
    det = np.array([[50, 50, 150, 150.0]])
    evs = [m.COCOEvalNP() for m in (JNP, TNP)]
    for ev in evs:
        ev.add_image(0, det, np.array([0.9]), gt, np.zeros(1, bool), np.zeros(0))
    want, got = _summaries(evs, "bbox")
    assert isinstance(want, IndexError)
    assert got["APs"] == 0.0 and got["AP"] == 0.0 and got["AR100"] == 0.0


def test_coco_eval_np_segm_perfect_and_shifted():
    """segm: masks equal to the GT's and masks shifted by 3 pixels,
    every image holding a detection in every range it has GT in; both
    cores agree key by key."""
    rs = np.random.RandomState(8)
    evs = [m.COCOEvalNP(iou_type="segm") for m in (JNP, TNP)]
    for img in range(4):
        gm = np.zeros((2, 32, 32), bool)
        for k in range(2):
            y, x = rs.randint(0, 16, 2)
            gm[k, y:y + 12, x:x + 12] = True
        dm = np.roll(gm, 3 * (img % 2), axis=2)
        boxes, scores = np.array([[0, 0, 12, 12.0]] * 2), rs.uniform(0.5, 1, 2)
        for ev in evs:
            ev.add_image(0, boxes, scores, boxes, np.zeros(2, bool),
                         gm.reshape(2, -1).sum(1).astype(float), det_masks=dm, gt_masks=gm)
    want, got = (ev.summarize() for ev in evs)
    for key, w in want.items():
        assert (math.isnan(w) and math.isnan(got[key])) or got[key] == w, (key, got[key], w)
    assert 0 < got["AP"] < got["AP50"] <= 1
