"""2D image processors (port of the parts of
`efg_tpu/data/processors/basic_2d.py` that the detection experiments use).

Host-side numpy and OpenCV, as efg_tpu's: `cv2` is imported where an
image or a mask is resized, not when the module is. The 2D data contract:
`data = {"image" [H, W, 3] float32, ...}`, `info["annotations"] =
{"boxes2d" [G, 4] xyxy, "classes" [G], "masks" [G, H, W] optional,
"sem_seg" [H, W] optional, "keypoints" [G, K, 3] optional}`. The
geometric helpers move the image, the boxes, the keypoints, the masks and
the semantic map together.

Ported: `ResizeShortestEdge` (which records the resize in
`metadata["scale"]`), `RandomFlip`, `NormalizeImage` and the fixed-shape
terminal `PadImage`. The Mask2Former recipe's processors (`ResizeScale`,
`FixedSizeCrop`, `Distortion`, the blend color augmentations,
`RandomSwapChannels`, `RasterizeMasks`) go with ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import numpy as np

from efg_tpu_torch.data.processors.base import AugmentationBase
from efg_tpu_torch.data.registry import PROCESSORS


# ---------------------------------------------------------------------------
# geometric helpers (image + boxes2d + keypoints + masks + sem_seg together)
# ---------------------------------------------------------------------------


def _resize_all(image, info, nh: int, nw: int):
    """Bilinear image resize (cv2.INTER_LINEAR), nearest for masks and the
    semantic map, scaled boxes and keypoints."""
    import cv2

    h, w = image.shape[:2]
    if (nh, nw) != (h, w):
        image = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    anno = info.get("annotations")
    if anno is not None:
        sx, sy = nw / w, nh / h
        if "boxes2d" in anno and len(anno["boxes2d"]):
            b = np.asarray(anno["boxes2d"], np.float32)
            b[:, [0, 2]] *= sx
            b[:, [1, 3]] *= sy
            anno["boxes2d"] = b
        if anno.get("keypoints") is not None and len(anno["keypoints"]):
            kp = np.asarray(anno["keypoints"], np.float32)
            kp[..., 0] *= sx
            kp[..., 1] *= sy
            anno["keypoints"] = kp
        if anno.get("masks") is not None and (nh, nw) != (h, w):
            m = np.asarray(anno["masks"])
            anno["masks"] = np.stack(
                [cv2.resize(mi.astype(np.uint8), (nw, nh), interpolation=cv2.INTER_NEAREST)
                 for mi in m]
            ) if len(m) else m.reshape((0, nh, nw))
        if anno.get("sem_seg") is not None and (nh, nw) != (h, w):
            anno["sem_seg"] = cv2.resize(anno["sem_seg"], (nw, nh),
                                         interpolation=cv2.INTER_NEAREST)
    return image, info


def _crop_all(image, info, x0: int, y0: int, cw: int, ch: int):
    """image[y0:y0+ch, x0:x0+cw] with the coordinates shifted; keypoints
    cropped away become unlabeled."""
    image = image[y0 : y0 + ch, x0 : x0 + cw]
    anno = info.get("annotations")
    if anno is not None:
        if "boxes2d" in anno and len(anno["boxes2d"]):
            b = np.asarray(anno["boxes2d"], np.float32)
            b[:, [0, 2]] -= x0
            b[:, [1, 3]] -= y0
            anno["boxes2d"] = b
        if anno.get("keypoints") is not None and len(anno["keypoints"]):
            kp = np.asarray(anno["keypoints"], np.float32)
            kp[..., 0] -= x0
            kp[..., 1] -= y0
            inside = ((kp[..., 0] >= 0) & (kp[..., 0] <= cw)
                      & (kp[..., 1] >= 0) & (kp[..., 1] <= ch))
            kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
            anno["keypoints"] = kp
        if anno.get("masks") is not None and len(anno["masks"]):
            anno["masks"] = np.asarray(anno["masks"])[:, y0 : y0 + ch, x0 : x0 + cw]
        if anno.get("sem_seg") is not None:
            anno["sem_seg"] = anno["sem_seg"][y0 : y0 + ch, x0 : x0 + cw]
    return image, info


def _pad_all(image, info, px1: int, py1: int, pad_value: float, seg_pad_value: int):
    """Right and bottom padding of the image, the masks and the semantic
    map."""
    if px1 or py1:
        image = np.pad(image, ((0, py1), (0, px1), (0, 0)), constant_values=pad_value)
        anno = info.get("annotations")
        if anno is not None:
            if anno.get("masks") is not None and len(anno["masks"]):
                anno["masks"] = np.pad(np.asarray(anno["masks"]), ((0, 0), (0, py1), (0, px1)))
            if anno.get("sem_seg") is not None:
                anno["sem_seg"] = np.pad(anno["sem_seg"], ((0, py1), (0, px1)),
                                         constant_values=seg_pad_value)
    return image, info


def _flip_all(image, info, horizontal: bool):
    """A horizontal or vertical flip; under a horizontal one the
    keypoints' left / right pairs swap by `metadata["keypoint_hflip_indices"]`."""
    h, w = image.shape[:2]
    anno = info.get("annotations")
    if horizontal:
        image = image[:, ::-1]
        if anno is not None:
            if "boxes2d" in anno and len(anno["boxes2d"]):
                b = np.asarray(anno["boxes2d"], np.float32)
                b[:, [0, 2]] = w - b[:, [2, 0]]
                anno["boxes2d"] = b
            if anno.get("masks") is not None and len(anno["masks"]):
                anno["masks"] = np.asarray(anno["masks"])[:, :, ::-1]
            if anno.get("sem_seg") is not None:
                anno["sem_seg"] = anno["sem_seg"][:, ::-1]
            if anno.get("keypoints") is not None and len(anno["keypoints"]):
                kp = np.asarray(anno["keypoints"], np.float32)
                kp[..., 0] = w - kp[..., 0]
                flip_idx = (info.get("metadata") or {}).get("keypoint_hflip_indices")
                if flip_idx is not None:
                    kp = kp[:, np.asarray(flip_idx)]
                anno["keypoints"] = kp
    else:
        image = image[::-1]
        if anno is not None:
            if "boxes2d" in anno and len(anno["boxes2d"]):
                b = np.asarray(anno["boxes2d"], np.float32)
                b[:, [1, 3]] = h - b[:, [3, 1]]
                anno["boxes2d"] = b
            if anno.get("keypoints") is not None and len(anno["keypoints"]):
                kp = np.asarray(anno["keypoints"], np.float32)
                kp[..., 1] = h - kp[..., 1]
                anno["keypoints"] = kp
            if anno.get("masks") is not None and len(anno["masks"]):
                anno["masks"] = np.asarray(anno["masks"])[:, ::-1]
            if anno.get("sem_seg") is not None:
                anno["sem_seg"] = anno["sem_seg"][::-1]
    return np.ascontiguousarray(image), info


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


@PROCESSORS.register()
class ResizeShortestEdge(AugmentationBase):
    """Resize so that the short edge is one of `short_edge_length` (drawn
    by `sample_style`: `choice`, or `range` for an integer in [min, max])
    with the long edge capped at `max_size`; the scale multiplies
    `metadata["scale"]`, which the evaluator divides out."""

    def __init__(self, short_edge_length, max_size=1333, sample_style="choice"):
        if isinstance(short_edge_length, (int, float)):
            short_edge_length = [int(short_edge_length)]
        self._init(locals())

    def __call__(self, image, info):
        h, w = image.shape[:2]
        if self.sample_style == "range":
            size = np.random.randint(min(self.short_edge_length), max(self.short_edge_length) + 1)
        else:
            size = int(np.random.choice(self.short_edge_length))
        scale = size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        image, info = _resize_all(image, info, nh, nw)
        info.setdefault("metadata", {})["scale"] = info.get("metadata", {}).get("scale", 1.0) * scale
        return image, info


@PROCESSORS.register()
class RandomFlip(AugmentationBase):
    def __init__(self, prob=0.5, horizontal=True, vertical=False):
        self._init(locals())

    def __call__(self, image, info):
        if self.horizontal and np.random.random() < self.prob:
            image, info = _flip_all(image, info, horizontal=True)
        if self.vertical and np.random.random() < self.prob:
            image, info = _flip_all(image, info, horizontal=False)
        return np.ascontiguousarray(image), info


@PROCESSORS.register()
class NormalizeImage(AugmentationBase):
    def __init__(self, mean=(103.53, 116.28, 123.675), std=(1.0, 1.0, 1.0)):
        self._init(locals())

    def __call__(self, image, info):
        image = (image.astype(np.float32) - np.asarray(self.mean)) / np.asarray(self.std)
        return image.astype(np.float32), info


@PROCESSORS.register()
class PadImage(AugmentationBase):
    """Pad (or cut) to a fixed (H, W) canvas at the top left, the
    fixed-shape contract; records the visible size in
    `metadata["image_size"]` and unlabels keypoints outside it."""

    def __init__(self, height: int, width: int):
        self._init(locals())

    def __call__(self, image, info):
        h, w = image.shape[:2]
        out = np.zeros((self.height, self.width, image.shape[2]), np.float32)
        ch, cw = min(h, self.height), min(w, self.width)
        out[:ch, :cw] = image[:ch, :cw]
        info.setdefault("metadata", {})["image_size"] = (ch, cw)
        anno = info.get("annotations")
        if anno is not None and anno.get("keypoints") is not None and len(anno["keypoints"]):
            kp = np.asarray(anno["keypoints"], np.float32)
            inside = ((kp[..., 0] >= 0) & (kp[..., 0] <= cw)
                      & (kp[..., 1] >= 0) & (kp[..., 1] <= ch))
            kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
            anno["keypoints"] = kp
        return dict(image=out), info
