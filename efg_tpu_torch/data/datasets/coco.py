"""COCO detection datasets (port of `COCODataset` and
`SyntheticCOCODataset` of `efg_tpu/data/datasets/coco.py`).

`COCODataset` parses `instances_*.json` directly (no pycocotools), emits
`(image, info)` with xyxy `boxes2d`, contiguous 0-based `classes` (the
category ids sorted), `iscrowd` and `areas`, and runs the 2D processor
chain. Train items drop images without a non-crowd instance when
`filter_empty_annotations` is on; the person-keypoints variant emits
[G, 17, 3] keypoints and drops train images with fewer than
`min_keypoints` visible ones. `aspect_ratios` (0 landscape, 1 portrait)
feed `DistributedGroupSampler`. Images are read by
`data/image_io.py` (BGR float32, as efg_tpu's cv2 reader).

`COCOPanopticDataset`: the instances json's images with the panoptic
json's segments: a (class, mask) target per non-crowd segment (things
and stuff) over the 133-category contiguous map of the panoptic
categories, and the evaluator's originals (`pan_gt`, `gt_segments`,
`gt_iscrowd_seg`), which the transforms pass through untouched.

`SyntheticCOCODataset`: coloured rectangles on noise, deterministic per
(seed, index), for runs without COCO on disk.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from efg_tpu_torch.data.base_dataset import BaseDataset
from efg_tpu_torch.data.builder import build_processors
from efg_tpu_torch.data.image_io import read_image, read_panoptic_ids
from efg_tpu_torch.data.registry import DATASETS

# COCO person-keypoints metadata: the 17 keypoint names in annotation
# order and the left/right pairs exchanged under a horizontal flip
COCO_PERSON_KEYPOINT_NAMES = (
    "nose",
    "left_eye", "right_eye",
    "left_ear", "right_ear",
    "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
    "left_hip", "right_hip",
    "left_knee", "right_knee",
    "left_ankle", "right_ankle",
)
COCO_PERSON_KEYPOINT_FLIP_MAP = (
    ("left_eye", "right_eye"),
    ("left_ear", "right_ear"),
    ("left_shoulder", "right_shoulder"),
    ("left_elbow", "right_elbow"),
    ("left_wrist", "right_wrist"),
    ("left_hip", "right_hip"),
    ("left_knee", "right_knee"),
    ("left_ankle", "right_ankle"),
)


def keypoint_hflip_indices(names=COCO_PERSON_KEYPOINT_NAMES,
                           flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP) -> np.ndarray:
    """The permutation of the K axis under a horizontal flip."""
    fmap = dict(flip_map)
    fmap.update({v: k for k, v in flip_map})
    flipped = [fmap.get(n, n) for n in names]
    return np.asarray([names.index(n) for n in flipped], np.int64)


def _split(config) -> str:
    return config.task if config.task != "test" else "val"


def _processors(config):
    d = config.dataset
    return build_processors(d.processors[config.task if config.task in d.processors
                                         else _split(config)])


@DATASETS.register()
class COCODataset(BaseDataset):
    def __init__(self, config):
        super().__init__(config)
        d = config.dataset
        task = _split(config)
        source = d.source
        root = source.root
        self.image_root = root + source[f"{task}_images"]
        json_file = root + source[f"{task}_json"]
        self.is_train = config.task == "train"
        self.filter_empty = bool(d.get("filter_empty_annotations", True))
        self.keypoints_on = bool(d.get("keypoints_on", False)) or (
            "keypoints" in os.path.basename(str(source.get(f"{task}_json", "")))
        )
        self.min_keypoints = int(d.get("min_keypoints", 1)) if self.is_train else 0
        self.keypoint_hflip_indices = keypoint_hflip_indices() if self.keypoints_on else None

        with open(json_file) as f:
            coco = json.load(f)
        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.cat_id_to_contiguous = {cid: i for i, cid in enumerate(cat_ids)}
        self.contiguous_to_cat_id = {i: cid for cid, i in self.cat_id_to_contiguous.items()}
        self.class_names = [c["name"] for c in sorted(coco["categories"], key=lambda c: c["id"])]

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.items = []
        for img in coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            if self.is_train and self.filter_empty and not any(
                a.get("iscrowd", 0) == 0 for a in anns
            ):
                continue
            if self.keypoints_on and self.min_keypoints > 0:
                vis = sum(
                    sum(1 for v in a.get("keypoints", [])[2::3] if v > 0)
                    for a in anns if a.get("iscrowd", 0) == 0
                )
                if vis < self.min_keypoints:
                    continue
            self.items.append((img, anns))

        self.transforms = _processors(config)
        self.aspect_ratios = np.asarray(
            [int(img["height"] > img["width"]) for img, _ in self.items], np.int64)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        img_meta, anns = self.items[idx]
        image = read_image(os.path.join(self.image_root, img_meta["file_name"]))

        boxes, classes, iscrowd, areas = [], [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            classes.append(self.cat_id_to_contiguous[a["category_id"]])
            iscrowd.append(a.get("iscrowd", 0))
            areas.append(a.get("area", w * h))
        info = {
            "metadata": {
                "image_id": img_meta["id"],
                "height": img_meta["height"],
                "width": img_meta["width"],
            },
            "annotations": {
                "boxes2d": np.asarray(boxes, np.float32).reshape(-1, 4),
                "classes": np.asarray(classes, np.int64),
                "iscrowd": np.asarray(iscrowd, np.int64),
                "areas": np.asarray(areas, np.float64),
            },
        }
        if self.keypoints_on:
            k = len(COCO_PERSON_KEYPOINT_NAMES)
            kpts = np.zeros((len(anns), k, 3), np.float32)
            for i, a in enumerate(anns):
                kp = np.asarray(a.get("keypoints", []), np.float32).reshape(-1, 3)
                if len(kp):
                    # COCO keypoints are pixel indices; +0.5 moves them to
                    # the floating-point coordinate convention
                    kp[:, :2] += 0.5
                    kpts[i, : len(kp)] = kp[:k]
            info["annotations"]["keypoints"] = kpts
            info["metadata"]["keypoint_hflip_indices"] = self.keypoint_hflip_indices
        return self._apply_transforms(image, info)


@DATASETS.register()
class COCOPanopticDataset(COCODataset):
    """COCO panoptic: the instance json's images, the panoptic json's
    segments and RGB-id PNGs (`panoptic_{split}_json`, PNGs under
    `panoptic_{split}_images`, default `/panoptic_{split}2017`)."""

    def __init__(self, config):
        super().__init__(config)
        source = config.dataset.source
        task = _split(config)
        self.pan_root = source.root + source.get(f"panoptic_{task}_images",
                                                 f"/panoptic_{task}2017")
        with open(source.root + source[f"panoptic_{task}_json"]) as f:
            pan = json.load(f)
        self.pan_by_img = {a["image_id"]: a for a in pan["annotations"]}
        # one contiguous map over the panoptic categories (things and
        # stuff) for the targets, the predictions and the evaluation
        pan_cats = sorted(pan.get("categories", []), key=lambda c: c["id"])
        if pan_cats:
            self.pan_cat_to_contiguous = {c["id"]: i for i, c in enumerate(pan_cats)}
            self.class_names = [c["name"] for c in pan_cats]
            self.thing_contiguous_ids = {i for i, c in enumerate(pan_cats) if c.get("isthing", 0)}
        else:  # a panoptic json without categories: the instance things only
            self.pan_cat_to_contiguous = dict(self.cat_id_to_contiguous)
            self.thing_contiguous_ids = set(self.pan_cat_to_contiguous.values())

    def __getitem__(self, idx):
        img_meta, _ = self.items[idx]
        image = read_image(os.path.join(self.image_root, img_meta["file_name"]))
        info = {
            "metadata": {"image_id": img_meta["id"], "height": img_meta["height"],
                         "width": img_meta["width"]},
            "annotations": {"boxes2d": np.zeros((0, 4), np.float32),
                            "classes": np.zeros(0, np.int64), "iscrowd": np.zeros(0, np.int64),
                            "areas": np.zeros(0, np.float64)},
        }
        pan_ann = self.pan_by_img.get(img_meta["id"])
        if pan_ann is not None:
            pan_id = read_panoptic_ids(os.path.join(self.pan_root, pan_ann["file_name"]))
            # one (class, mask) target per non-crowd segment, made before the
            # transforms so that the crop moves the masks with the image
            segs = [s for s in pan_ann["segments_info"]
                    if not s.get("iscrowd", 0) and s["category_id"] in self.pan_cat_to_contiguous]
            masks = np.stack([(pan_id == s["id"]).astype(np.uint8) for s in segs]) if segs \
                else np.zeros((0,) + pan_id.shape, np.uint8)
            boxes = np.zeros((len(segs), 4), np.float32)
            for i, m in enumerate(masks):
                ys, xs = np.nonzero(m)
                if len(ys):
                    boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
            anno = info["annotations"]
            anno.update(
                boxes2d=boxes,
                classes=np.asarray([self.pan_cat_to_contiguous[s["category_id"]] for s in segs],
                                   np.int64),
                iscrowd=np.zeros(len(segs), np.int64),
                areas=np.asarray([s.get("area", 0) for s in segs], np.float64),
                masks=masks,
            )
            # the evaluator's originals, at the image's own resolution
            anno["pan_gt"] = pan_id
            anno["gt_segments"] = {s["id"]: self.pan_cat_to_contiguous.get(s["category_id"], -1)
                                   for s in pan_ann["segments_info"]}
            anno["gt_iscrowd_seg"] = {s["id"]: bool(s.get("iscrowd", 0))
                                      for s in pan_ann["segments_info"]}
        return self._apply_transforms(image, info)


@DATASETS.register()
class SyntheticCOCODataset(BaseDataset):
    """Procedural 2D scenes: 1-5 coloured rectangles on noise, class-coloured,
    deterministic per (dataset.seed, index)."""

    def __init__(self, config):
        super().__init__(config)
        d = config.dataset
        self.size = int(d.get("num_frames", 64))
        self.seed = int(d.get("seed", 0))
        self.num_classes = int(d.get("num_classes", 5))
        self.image_size = int(d.get("image_size", 256))
        self.transforms = _processors(config)
        self.class_names = [f"class{i}" for i in range(self.num_classes)]

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rs = np.random.RandomState(self.seed * 9176 + idx)
        s = self.image_size
        image = rs.uniform(0, 60, (s, s, 3)).astype(np.float32)
        k = rs.randint(1, 6)
        boxes, classes = [], []
        for _ in range(k):
            w, h = rs.uniform(s * 0.1, s * 0.4, 2)
            x0 = rs.uniform(0, s - w)
            y0 = rs.uniform(0, s - h)
            cls = rs.randint(self.num_classes)
            color = np.zeros(3)
            color[cls % 3] = 150 + 50 * (cls // 3)
            image[int(y0):int(y0 + h), int(x0):int(x0 + w)] += color
            boxes.append([x0, y0, x0 + w, y0 + h])
            classes.append(cls)
        info = {
            "metadata": {"image_id": idx, "height": s, "width": s},
            "annotations": {
                "boxes2d": np.asarray(boxes, np.float32),
                "classes": np.asarray(classes, np.int64),
                "iscrowd": np.zeros(k, np.int64),
                "areas": np.asarray([(b[2] - b[0]) * (b[3] - b[1]) for b in boxes], np.float64),
            },
        }
        return self._apply_transforms(image, info)
