"""Image files → arrays, as efg_tpu's datasets read them.

`read_image` decodes with OpenCV (`cv2.imread`, imported at the call),
efg_tpu's reader: BGR, float32, [H, W, 3]. A file that cannot be read
raises; nothing falls back to another decoder.
"""

from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    """The image at `path` as a BGR float32 array [H, W, 3]."""
    import cv2

    image = cv2.imread(path)
    if image is None:
        what = "no such file" if not os.path.exists(path) else "cv2 cannot decode it"
        raise OSError(f"cannot read image {path}: {what}")
    return image.astype(np.float32)
