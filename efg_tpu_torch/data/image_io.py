"""Image files → arrays, as efg_tpu's datasets read them.

`read_image` decodes with OpenCV (`cv2.imread`, imported at the call),
efg_tpu's reader: BGR, float32, [H, W, 3]. `read_panoptic_ids` decodes
a COCO panoptic PNG into its segment ids, R + G·256 + B·256². A file that
cannot be read raises; nothing falls back to another decoder.
"""

from __future__ import annotations

import os

import numpy as np


def _imread(path: str) -> np.ndarray:
    import cv2

    image = cv2.imread(path)
    if image is None:
        what = "no such file" if not os.path.exists(path) else "cv2 cannot decode it"
        raise OSError(f"cannot read image {path}: {what}")
    return image


def read_image(path: str) -> np.ndarray:
    """The image at `path` as a BGR float32 array [H, W, 3]."""
    return _imread(path).astype(np.float32)


def read_panoptic_ids(path: str) -> np.ndarray:
    """The segment ids [H, W] int64 of the COCO panoptic PNG at `path`:
    R + G·256 + B·256² of its RGB pixels."""
    png = _imread(path)  # BGR
    return (png[..., 2].astype(np.int64) + png[..., 1].astype(np.int64) * 256
            + png[..., 0].astype(np.int64) * 256 ** 2)
