"""Port parity of the panoptic data path and evaluation (efg_tpu_torch vs
efg_tpu), host code held equal item by item:

- the eight processors of the Mask2Former recipe (`ResizeScale`,
  `FixedSizeCrop` cropping and padding, `Distortion`, `RandomBrightness`,
  `RandomSaturation`, `RandomLightning`, `RandomSwapChannels`,
  `RasterizeMasks` from masks and from boxes) and the LSJ chain, on an
  image with boxes, masks, a semantic map and keypoints, under several
  `np.random` seeds;
- `COCOPanopticDataset` on a fixture written in the COCO panoptic format
  (`write_coco_panoptic`: RGB-id PNGs with ids using all three channels,
  things and stuff of gapped category ids, a crowd segment, void pixels,
  a train image without a thing, which both packages drop), read through
  the COCO panoptic R-50 config with its canvas cut by dotlist: train
  (LSJ) and val items equal under one seed, the 133-style contiguous map
  and `thing_contiguous_ids`;
- `pq_single_image`, `summarize_pq`, `assemble_panoptic` and
  `PanopticEvaluator` (raw `predict_panoptic` outputs on the val batches:
  unpadded at mask scale, resized to the GT) give efg_tpu's numbers; the
  GT fed back as predictions reads PQ = SQ = RQ = 1 exactly;
- the two failures of the COCO panoptic configs as written, in both
  packages: their schedule gives `milestones_epochs` and no `milestones`
  (TypeError from `warmup_multi_step`), and they name
  `COCOPanopticEvaluator`, which neither registers (KeyError).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import efg_tpu.data as JD
import efg_tpu.evaluator  # noqa: F401  (registrations)
from efg_tpu.config import Configuration as JConfiguration
from efg_tpu.data.builder import build_processors as j_build_processors
from efg_tpu.data.processors import basic_2d as JP
from efg_tpu.data.processors.base import compose_processors as j_compose
from efg_tpu.evaluator import panoptic_evaluator as JPE
from efg_tpu.evaluator.build import build_evaluators as j_build_evaluators
from efg_tpu.solver.schedulers import build_scheduler as j_build_scheduler
import efg_tpu_torch.data as TD
import efg_tpu_torch.evaluator  # noqa: F401  (registrations)
from efg_tpu_torch.config import Configuration
from efg_tpu_torch.data import builder as TB
from efg_tpu_torch.data.processors import basic_2d as TP
from efg_tpu_torch.data.processors.base import compose_processors as t_compose
from efg_tpu_torch.evaluator import panoptic_evaluator as TPE
from efg_tpu_torch.evaluator.build import build_evaluators as t_build_evaluators
from efg_tpu_torch.solver.schedulers import build_scheduler as t_build_scheduler

from test_torch_data import _equal

ROOT = Path(__file__).resolve().parents[1]
PANO = "panoptic_seg/coco/mask2former/mask2former.pano_coco.{}.bs16.50e"
CONFIGS = {k: str(ROOT / "playground" / PANO.format(k) / "config.yaml") for k in ("res50", "swin_t")}
# (id, name, isthing): gapped ids, things and stuff; the instance json
# lists the things
PANOPTIC_CATEGORIES = [(1, "person", 1), (3, "car", 1), (18, "dog", 1), (149, "road", 0),
                       (187, "sky-other-merged", 0)]
TRAIN_SIZES = [(48, 64), (64, 48), (40, 60), (60, 40), (48, 64)]
VAL_SIZES = [(48, 64), (64, 48), (43, 64)]


def write_coco_panoptic(root, split, sizes, seed):
    """A COCO panoptic split under `root`: `{split}2017/` PNG images,
    `panoptic_{split}2017/` RGB-id PNGs (id = R + G·256 + B·256²), the
    instance json (the things) and the panoptic json (`segments_info`,
    `categories` with `isthing`). Each image: a sky band, a road band, a
    void strip between them, 1-3 thing rectangles over them (3 on the
    first image, whose last is a crowd segment); the second-to-last image
    holds no thing."""
    rs = np.random.RandomState(seed)
    root = Path(root)
    for d in (f"{split}2017", f"panoptic_{split}2017", "annotations"):
        (root / d).mkdir(parents=True, exist_ok=True)
    images, inst, pano = [], [], []
    things = [c for c in PANOPTIC_CATEGORIES if c[2]]
    for i, (h, w) in enumerate(sizes):
        img_id = 1000 * seed + 7 * i + 3
        name = f"{img_id:012d}"
        ids = np.zeros((h, w), np.int64)
        segs = []

        def add(mask, cat, crowd=0):
            sid = int(rs.randint(1, 2 ** 24))
            ids[mask] = sid
            ys, xs = np.nonzero(ids == sid)
            bbox = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                    int(ys.max() - ys.min() + 1)]
            segs.append(dict(id=sid, category_id=cat, iscrowd=crowd, bbox=bbox,
                             area=int((ids == sid).sum())))
            return bbox

        band = np.zeros((h, w), bool)
        band[: h // 3] = True
        add(band, 187)
        band = np.zeros((h, w), bool)
        band[h // 3 + 2:] = True
        add(band, 149)  # rows h//3 .. h//3+1 stay void
        n_things = 0 if i == len(sizes) - 2 else 3 if i == 0 else rs.randint(1, 4)
        for k in range(n_things):
            bw, bh = rs.randint(8, w // 2), rs.randint(8, h // 2)
            x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
            m = np.zeros((h, w), bool)
            m[y:y + bh, x:x + bw] = True
            crowd = int(i == 0 and k == n_things - 1)
            cat = things[rs.randint(len(things))][0]
            bbox = add(m, cat, crowd)
            inst.append(dict(id=len(inst) + 1, image_id=img_id, category_id=cat, bbox=bbox,
                             area=float(bbox[2] * bbox[3]), iscrowd=crowd))
        # a thing drawn over others may be covered whole: drop segments left empty
        segs = [s for s in segs if (ids == s["id"]).any()]
        png = np.stack([ids // 256 ** 2, (ids // 256) % 256, ids % 256], -1).astype(np.uint8)
        assert cv2.imwrite(str(root / f"panoptic_{split}2017" / f"{name}.png"), png)
        pixels = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        assert cv2.imwrite(str(root / f"{split}2017" / f"{name}.png"), pixels)
        images.append(dict(id=img_id, file_name=f"{name}.png", height=h, width=w))
        pano.append(dict(image_id=img_id, file_name=f"{name}.png", segments_info=segs))
    cats = [dict(id=c, name=n, isthing=t, supercategory="x") for c, n, t in PANOPTIC_CATEGORIES]
    with open(root / "annotations" / f"instances_{split}2017.json", "w") as f:
        json.dump(dict(images=images, annotations=inst, categories=[c for c in cats if c["isthing"]]), f)
    with open(root / "annotations" / f"panoptic_{split}2017.json", "w") as f:
        json.dump(dict(images=images, annotations=pano, categories=cats[::-1]), f)


def small_opts(root, canvas=(64, 96), lsj=128):
    """Dotlists for the COCO panoptic configs: the fixture's root, the LSJ
    target and crop at `lsj`, the val short edge at canvas[0] (long edge at
    most canvas[1]) on a canvas of `canvas`, a seed."""
    h, w = canvas
    return [f"detection.source.local.root={root}", "misc.seed=3",
            f"dataset.processors.train[1].ResizeScale.target_height={lsj}",
            f"dataset.processors.train[1].ResizeScale.target_width={lsj}",
            f"dataset.processors.train[2].FixedSizeCrop.crop_size=[{lsj},{lsj}]",
            f"dataset.processors.train[4].RasterizeMasks.height={lsj}",
            f"dataset.processors.train[4].RasterizeMasks.width={lsj}",
            f"dataset.processors.train[5].PadImage.height={lsj}",
            f"dataset.processors.train[5].PadImage.width={lsj}",
            f"dataset.processors.val[0].ResizeShortestEdge.short_edge_length={h}",
            f"dataset.processors.val[0].ResizeShortestEdge.max_size={w}",
            f"dataset.processors.val[2].RasterizeMasks.height={h}",
            f"dataset.processors.val[2].RasterizeMasks.width={w}",
            f"dataset.processors.val[3].PadImage.height={h}",
            f"dataset.processors.val[3].PadImage.width={w}"]


@pytest.fixture(scope="module")
def pano_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_panoptic")
    write_coco_panoptic(root, "train", TRAIN_SIZES, 1)
    write_coco_panoptic(root, "val", VAL_SIZES, 2)
    return root


@pytest.fixture
def configs(pano_root, monkeypatch):
    monkeypatch.setenv("EFG_PATH", str(ROOT))

    def make(*opts, name="res50"):
        opts = small_opts(pano_root) + list(opts)
        return (JConfiguration(config_file=CONFIGS[name], opts=list(opts)).get_config(),
                Configuration(config_file=CONFIGS[name], opts=list(opts)).get_config())

    return make


# ---------------------------------------------------------------- processors


def _sample(seed=0, h=50, w=70):
    rs = np.random.RandomState(seed)
    image = rs.uniform(0, 255, (h, w, 3)).astype(np.float32)
    masks = np.zeros((3, h, w), np.uint8)
    boxes = []
    for i in range(3):
        x0, y0 = rs.randint(0, w - 20), rs.randint(0, h - 20)
        masks[i, y0:y0 + rs.randint(5, 20), x0:x0 + rs.randint(5, 20)] = 1
        ys, xs = np.nonzero(masks[i])
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    info = {"metadata": {"image_id": seed},
            "annotations": {"boxes2d": np.asarray(boxes, np.float32),
                            "classes": np.arange(3, dtype=np.int64),
                            "iscrowd": np.zeros(3, np.int64),
                            "areas": masks.reshape(3, -1).sum(1).astype(np.float64),
                            "masks": masks,
                            "sem_seg": rs.randint(0, 5, (h, w)).astype(np.uint8),
                            "keypoints": np.concatenate([rs.uniform(0, w, (3, 4, 1)),
                                                         rs.uniform(0, h, (3, 4, 1)),
                                                         np.full((3, 4, 1), 2.0)], -1)
                            .astype(np.float32)}}
    return image, info


PROCESSORS = [
    ("ResizeScale", dict(min_scale=0.1, max_scale=2.0, target_height=64, target_width=64)),
    ("FixedSizeCrop", dict(crop_size=[40, 48])),
    ("FixedSizeCrop", dict(crop_size=[80, 96])),
    ("FixedSizeCrop", dict(crop_size=[40, 96], pad=False)),
    ("Distortion", dict(hue=0.1, saturation=1.5, exposure=1.5)),
    ("Distortion", dict(hue=0.2, saturation=200, exposure=1.2, image_format="RGB")),
    ("RandomBrightness", dict(intensity_min=0.6, intensity_max=1.4)),
    ("RandomSaturation", dict(intensity_min=0.6, intensity_max=1.4, prob=0.5)),
    ("RandomLightning", dict(scale=0.1, prob=0.5)),
    ("RandomSwapChannels", dict(prob=0.5)),
    ("RasterizeMasks", dict(height=48, width=64, stride=4)),
]


@pytest.mark.parametrize("name,kw", PROCESSORS, ids=[f"{n}{i}" for i, (n, _) in enumerate(PROCESSORS)])
def test_processors_equal(name, kw):
    jp, tp = getattr(JP, name)(**kw), getattr(TP, name)(**kw)
    for seed in range(6):
        image, info = _sample(seed)
        np.random.seed(seed)
        want = jp(image.copy(), copy.deepcopy(info))
        np.random.seed(seed)
        got = tp(image.copy(), copy.deepcopy(info))
        after = np.random.rand()
        _equal(want, got, f"{name} seed {seed}")
        np.random.seed(seed)
        jp(image.copy(), copy.deepcopy(info))
        assert np.random.rand() == after  # both consumed the same draws


def test_rasterize_masks_from_boxes_and_dropped_instances():
    """Without `masks`, the box rectangles; a mask the crop emptied drops its
    instance's boxes, classes, iscrowd, areas and keypoints."""
    for kw in (dict(height=48, width=64, stride=4), dict(height=48, width=64, stride=8)):
        image, info = _sample(1)
        del info["annotations"]["masks"]
        _equal(JP.RasterizeMasks(**kw)(image, copy.deepcopy(info)),
               TP.RasterizeMasks(**kw)(image, copy.deepcopy(info)))
    image, info = _sample(2)
    info["annotations"]["masks"][1] = 0
    want = JP.RasterizeMasks(48, 64)(image, copy.deepcopy(info))
    got = TP.RasterizeMasks(48, 64)(image, copy.deepcopy(info))
    _equal(want, got)
    assert len(got[1]["annotations"]["classes"]) == 2 == len(got[1]["annotations"]["keypoints"])


def test_lsj_chain_equal(configs):
    jc, tc = configs("task=train")
    jchain = j_build_processors(jc.dataset.processors.train)
    tchain = TB.build_processors(tc.dataset.processors.train)
    assert [type(p).__name__ for p in tchain] == [
        "RandomFlip", "ResizeScale", "FixedSizeCrop", "NormalizeImage", "RasterizeMasks", "PadImage"]
    for seed in range(8):
        image, info = _sample(seed, 90, 60)
        np.random.seed(seed)
        want = j_compose(jchain)(image.copy(), copy.deepcopy(info))
        np.random.seed(seed)
        got = t_compose(tchain)(image.copy(), copy.deepcopy(info))
        _equal(want, got, f"seed {seed}")


# ------------------------------------------------------------------ dataset


@pytest.mark.parametrize("split", ["train", "val"])
def test_panoptic_items_equal(configs, split):
    jc, tc = configs(f"task={split}")
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    sizes = TRAIN_SIZES if split == "train" else VAL_SIZES
    assert len(jds) == len(tds) == len(sizes) - (split == "train")  # train drops the thing-less
    assert jds.pan_cat_to_contiguous == tds.pan_cat_to_contiguous == {
        1: 0, 3: 1, 18: 2, 149: 3, 187: 4}
    assert jds.thing_contiguous_ids == tds.thing_contiguous_ids == {0, 1, 2}
    assert jds.class_names == tds.class_names
    crowd = 0
    for idx in range(len(tds)):
        for rep in range(2 if split == "train" else 1):
            np.random.seed(100 * idx + rep)
            want = jds[idx]
            np.random.seed(100 * idx + rep)
            got = tds[idx]
            _equal(want, got, f"{split} item {idx}")
            anno = got[1]["annotations"]
            crowd += sum(anno["gt_iscrowd_seg"].values())
            assert anno["pan_gt"].max() > 256 ** 2  # ids span all three channels
            assert set(np.unique(anno["pan_gt"])) <= set(anno["gt_segments"]) | {0}
    assert crowd == (2 if split == "train" else 1)
    canvas = (128, 128) if split == "train" else (64, 96)
    assert got[0]["image"].shape == canvas + (3,)
    assert got[1]["annotations"]["masks_fixed"].shape[1:] == (canvas[0] // 4, canvas[1] // 4)


def test_panoptic_without_categories_block(configs, tmp_path):
    """A panoptic json without `categories`: the instance things' map."""
    root = tmp_path / "nocats"
    write_coco_panoptic(root, "val", VAL_SIZES[:1], 4)
    pj = root / "annotations" / "panoptic_val2017.json"
    data = json.loads(pj.read_text())
    del data["categories"]
    pj.write_text(json.dumps(data))
    jc, tc = configs("task=val", f"detection.source.local.root={root}")
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    assert jds.pan_cat_to_contiguous == tds.pan_cat_to_contiguous == {1: 0, 3: 1, 18: 2}
    assert jds.thing_contiguous_ids == tds.thing_contiguous_ids == {0, 1, 2}
    _equal(jds[0], tds[0])


# ---------------------------------------------------------------- evaluation


def _random_maps(seed, h=30, w=40):
    """(pan_pred, pred_segments, pan_gt, gt_segments, gt_iscrowd): six GT
    rectangles (the first a crowd), predictions that rename them, void a
    tenth of their pixels, relabel some, and add a stray row segment."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((h, w), np.int64)
    cats, crowd = {}, {}
    for k, sid in enumerate(rs.choice(np.arange(1, 1000), 6, replace=False)):
        y, x = rs.randint(0, h - 8), rs.randint(0, w - 8)
        gt[y:y + rs.randint(4, 16), x:x + rs.randint(4, 16)] = sid
        cats[int(sid)], crowd[int(sid)] = int(rs.randint(0, 4)), k == 0
    gt_segments = {s: c for s, c in cats.items() if (gt == s).any()}
    pred = np.where(gt > 0, gt + 2000, 0)
    pred[rs.rand(h, w) < 0.1] = 0
    pred[rs.randint(0, h)] = 5000
    pred_segments = {s + 2000: c if rs.rand() < 0.8 else int(rs.randint(0, 4))
                     for s, c in gt_segments.items() if (pred == s + 2000).any()}
    pred_segments[5000] = int(rs.randint(0, 4))
    return pred, pred_segments, gt, gt_segments, {s: crowd[s] for s in gt_segments}


def test_pq_core_matches():
    jstats, tstats = {}, {}
    for seed in range(6):
        maps = _random_maps(seed)
        JPE.pq_single_image(*maps, jstats)
        TPE.pq_single_image(*maps, tstats)
    assert jstats.keys() == tstats.keys()
    for k in jstats:
        np.testing.assert_array_equal(jstats[k], tstats[k])
    assert JPE.summarize_pq(jstats) == TPE.summarize_pq(tstats)
    assert 0 < TPE.summarize_pq(tstats)["PQ"] < 1
    assert JPE.summarize_pq({}) == TPE.summarize_pq({})


def test_assemble_panoptic_matches():
    rs = np.random.RandomState(0)
    for _ in range(5):
        ps = rs.randint(0, 9, (12, 15))
        labels, keep = rs.randint(0, 5, 8), rs.rand(8) < 0.7
        want = JPE.assemble_panoptic(ps, labels, keep, {0, 1})
        got = TPE.assemble_panoptic(ps, labels, keep, {0, 1})
        _equal(want, got)


def _val_batches(tc, tds):
    loader = TB.build_dataloader(tc, tds, train=False)
    return list(loader)


def test_panoptic_evaluator_matches(configs):
    jc, tc = configs("task=val", "trainer.evaluators=[PanopticEvaluator]")
    jds, tds = JD.build_dataset(jc), TD.build_dataset(tc)
    (jev,), (tev,) = j_build_evaluators(jc, jds), t_build_evaluators(tc, tds)
    rs = np.random.RandomState(5)
    for ev in (jev, tev):
        ev.reset()
    batches = _val_batches(tc, tds)
    for batch in batches:
        b, hm, wm = len(batch["annotations"]), 64 // 4, 96 // 4
        out = dict(pan_seg=rs.randint(0, 7, (b, hm, wm)), pan_labels=rs.randint(0, 5, (b, 6)),
                   pan_keep=rs.rand(b, 6) < 0.8, pan_scores=rs.rand(b, 6))
        jev.process(batch, out)
        tev.process(batch, out)
    want, got = jev.evaluate(), tev.evaluate()
    assert want == got and set(got) == {"panoptic/PQ", "panoptic/SQ", "panoptic/RQ",
                                        "panoptic/n_categories"}

    # the GT as predictions: a perfect segmenter
    tev.reset()
    for batch in batches:
        annos = batch["annotations"]
        tev.process(batch, dict(pan_pred=[a["pan_gt"] for a in annos],
                                pred_segments=[a["gt_segments"] for a in annos]))
    res = tev.evaluate()
    assert res["panoptic/PQ"] == res["panoptic/SQ"] == res["panoptic/RQ"] == 1.0


# ------------------------------------------------- the configs' own failures


@pytest.mark.parametrize("name", ["res50", "swin_t"])
def test_coco_panoptic_configs_fail_as_in_efg_tpu(configs, name):
    """As written, the schedule gives `milestones_epochs` and no
    `milestones`, which the trainers' `setup_optimizer` passes on to
    `warmup_multi_step`; and `COCOPanopticEvaluator` is registered by
    neither package."""
    jc, tc = configs("task=train", name=name)
    for cfg, build in ((jc, j_build_scheduler), (tc, t_build_scheduler)):
        sched = dict(cfg.solver.lr_scheduler, lr=cfg.solver.optimizer.lr, max_iters=100)
        assert "milestones_epochs" in sched and "milestones" not in sched
        with pytest.raises(TypeError, match="milestones"):
            build(sched)
    assert list(jc.trainer.evaluators) == list(tc.trainer.evaluators) == ["COCOPanopticEvaluator"]
    with pytest.raises(KeyError, match="COCOPanopticEvaluator"):
        j_build_evaluators(jc, None)
    with pytest.raises(KeyError, match="COCOPanopticEvaluator"):
        t_build_evaluators(tc, None)
