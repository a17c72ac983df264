"""2D image processors (port of `efg_tpu/data/processors/basic_2d.py`).

Host-side numpy and OpenCV, as efg_tpu's: `cv2` is imported where an
image or a mask is resized, not when the module is. The 2D data contract:
`data = {"image" [H, W, 3] float32, ...}`, `info["annotations"] =
{"boxes2d" [G, 4] xyxy, "classes" [G], "masks" [G, H, W] optional,
"sem_seg" [H, W] optional, "keypoints" [G, K, 3] optional}`. The
geometric helpers move the image, the boxes, the keypoints, the masks and
the semantic map together.

All of efg_tpu's processors: `ResizeShortestEdge` (which records the
resize in `metadata["scale"]`), `RandomFlip`, the large-scale-jitter pair
`ResizeScale` + `FixedSizeCrop` (the Mask2Former recipe), the HSV
`Distortion`, the blend colour augmentations (`RandomBrightness`,
`RandomSaturation`, `RandomLightning`), `RandomSwapChannels`,
`NormalizeImage`, and the fixed-shape terminals `RasterizeMasks` and
`PadImage`. Each draws from the global `np.random` stream in efg_tpu's
order, so a seeded item equals efg_tpu's.
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
class ResizeScale(AugmentationBase):
    """Random-scale resize toward a target box, aspect ratio kept: the
    resize half of large-scale jitter."""

    def __init__(self, min_scale: float, max_scale: float,
                 target_height: int, target_width: int):
        self._init(locals())

    def __call__(self, image, info):
        h, w = image.shape[:2]
        scale = np.random.uniform(self.min_scale, self.max_scale)
        tsh, tsw = self.target_height * scale, self.target_width * scale
        out_scale = min(tsh / h, tsw / w)
        nh, nw = int(round(h * out_scale)), int(round(w * out_scale))
        image, info = _resize_all(image, info, nh, nw)
        info.setdefault("metadata", {})["scale"] = info.get("metadata", {}).get("scale", 1.0) * out_scale
        return image, info


@PROCESSORS.register()
class FixedSizeCrop(AugmentationBase):
    """Random crop to `crop_size` where larger, right / bottom padding where
    smaller (`pad_value` for the image, `seg_pad_value` for the semantic
    map): the crop half of large-scale jitter."""

    def __init__(self, crop_size, pad: bool = True, pad_value: float = 128.0,
                 seg_pad_value: int = 255):
        crop_size = tuple(int(c) for c in crop_size)
        self._init(locals())

    def __call__(self, image, info):
        h, w = image.shape[:2]
        oh, ow = self.crop_size
        max_off = np.maximum([h - oh, w - ow], 0)
        off = np.round(max_off * np.random.uniform(0.0, 1.0)).astype(int)
        image, info = _crop_all(image, info, int(off[1]), int(off[0]), ow, oh)
        if self.pad:
            nh, nw = image.shape[:2]
            image, info = _pad_all(image, info, max(ow - nw, 0), max(oh - nh, 0),
                                   self.pad_value, self.seg_pad_value)
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
class Distortion(AugmentationBase):
    """HSV jitter: hue shifted by U(−hue, hue) (wrapped), saturation and
    exposure scaled by a factor in [1, upper] or its inverse; through
    uint8 HSV (OpenCV) as efg_tpu's."""

    def __init__(self, hue, saturation, exposure, image_format="BGR"):
        if image_format not in ("RGB", "BGR"):
            raise KeyError(image_format)
        if saturation > 1.0:
            saturation /= 255.0
        self._init(locals())

    @staticmethod
    def _rand_scale(upper):
        scale = np.random.uniform(1, upper)
        return scale if np.random.rand() > 0.5 else 1.0 / scale

    def __call__(self, image, info):
        import cv2

        to_hsv, from_hsv = {"RGB": (cv2.COLOR_RGB2HSV, cv2.COLOR_HSV2RGB),
                            "BGR": (cv2.COLOR_BGR2HSV, cv2.COLOR_HSV2BGR)}[self.image_format]
        dhue = np.random.uniform(-self.hue, self.hue)
        dsat = self._rand_scale(self.saturation)
        dexp = self._rand_scale(self.exposure)
        dtype = image.dtype
        img = cv2.cvtColor(image.astype(np.uint8) if dtype != np.uint8 else image, to_hsv)
        img = img.astype(np.float32) / 255.0
        img[:, :, 1] *= dsat
        img[:, :, 2] *= dexp
        hue = img[:, :, 0] + dhue
        hue = np.where(hue > 1.0, hue - 1.0, hue) if dhue > 0 else np.where(hue < 0.0, hue + 1.0, hue)
        img[:, :, 0] = hue
        img = (img * 255).clip(0, 255).astype(np.uint8)
        return cv2.cvtColor(img, from_hsv).astype(dtype), info


class _Blend(AugmentationBase):
    """src_weight·src + dst_weight·image, clipped for uint8 images."""

    def _blend(self, image, src, sw, dw):
        if image.dtype == np.uint8:
            out = sw * src + dw * image.astype(np.float32)
            return np.clip(out, 0, 255).astype(np.uint8)
        return (sw * src + dw * image).astype(image.dtype)


@PROCESSORS.register()
class RandomBrightness(_Blend):
    def __init__(self, intensity_min, intensity_max, prob=1.0):
        self._init(locals())

    def __call__(self, image, info):
        if np.random.random() < self.prob:
            w = np.random.uniform(self.intensity_min, self.intensity_max)
            image = self._blend(image, 0.0, 1 - w, w)
        return image, info


@PROCESSORS.register()
class RandomSaturation(_Blend):
    def __init__(self, intensity_min, intensity_max, prob=1.0):
        self._init(locals())

    def __call__(self, image, info):
        if np.random.random() < self.prob:
            w = np.random.uniform(self.intensity_min, self.intensity_max)
            gray = image[..., :3].astype(np.float32).dot([0.299, 0.587, 0.114])[..., None]
            image = self._blend(image, gray, 1 - w, w)
        return image, info


@PROCESSORS.register()
class RandomLightning(_Blend):
    """ImageNet-PCA colour jitter."""

    EIGEN_VECS = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
    EIGEN_VALS = np.array([0.2175, 0.0188, 0.0045])

    def __init__(self, scale, prob=0.5):
        self._init(locals())

    def __call__(self, image, info):
        if np.random.random() < self.prob:
            weights = np.random.normal(scale=self.scale, size=3)
            src = self.EIGEN_VECS.dot(weights * self.EIGEN_VALS)
            image = self._blend(image, src, 1.0, 1.0)
        return image, info


@PROCESSORS.register()
class RandomSwapChannels(AugmentationBase):
    def __init__(self, prob=0.5):
        self._init(locals())

    def __call__(self, image, info):
        if np.random.random() < self.prob:
            image = image[..., np.random.permutation(3)]
        return image, info


@PROCESSORS.register()
class NormalizeImage(AugmentationBase):
    def __init__(self, mean=(103.53, 116.28, 123.675), std=(1.0, 1.0, 1.0)):
        self._init(locals())

    def __call__(self, image, info):
        image = (image.astype(np.float32) - np.asarray(self.mean)) / np.asarray(self.std)
        return image.astype(np.float32), info


@PROCESSORS.register()
class RasterizeMasks(AugmentationBase):
    """Instance masks on the fixed mask-scale grid (height / stride, width /
    stride) for the segmentation criterion: `annotations["masks_fixed"]`
    [G, hm, wm] f32, from the full-resolution `masks` (nearest), else from
    the box rectangles. Instances whose mask the transforms emptied (cut
    away by a crop) are dropped from boxes, classes, iscrowd, areas,
    keypoints and masks together."""

    def __init__(self, height: int, width: int, stride: int = 4):
        self._init(locals())

    def __call__(self, image, info):
        anno = info.get("annotations")
        if anno is None:
            return image, info
        hm, wm = self.height // self.stride, self.width // self.stride
        masks = anno.get("masks")
        if masks is not None:
            import cv2

            masks = np.asarray(masks)
            keep = masks.reshape(len(masks), -1).any(axis=1) if len(masks) else np.zeros(0, bool)
            for key in ("boxes2d", "classes", "iscrowd", "areas", "keypoints"):
                if key in anno and len(anno[key]) == len(keep):
                    anno[key] = np.asarray(anno[key])[keep]
            masks = masks[keep]
            out = np.zeros((len(masks), hm, wm), np.float32)
            for i, m in enumerate(masks):
                out[i] = cv2.resize(m.astype(np.float32), (wm, hm),
                                    interpolation=cv2.INTER_NEAREST)[:hm, :wm]
        else:
            boxes = np.asarray(anno.get("boxes2d", np.zeros((0, 4)))) / self.stride
            out = np.zeros((len(boxes), hm, wm), np.float32)
            for i, (x0, y0, x1, y1) in enumerate(boxes):
                out[i, int(max(y0, 0)):int(min(y1, hm)), int(max(x0, 0)):int(min(x1, wm))] = 1.0
        anno["masks_fixed"] = out
        return image, info


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
