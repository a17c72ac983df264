"""Processor (augmentation) base machinery (a copy of
`efg_tpu/data/processors/base.py`): the `(points, info) → (points, info)`
processor contract. Host-side numpy; random draws come from numpy's
global RNG, which the loader seeds per item (`data/builder.py`).
"""

from __future__ import annotations

import numpy as np

from efg_tpu_torch.data.registry import PROCESSORS


class AugmentationBase:
    def _init(self, params: dict) -> None:
        for k, v in params.items():
            if k != "self" and not k.startswith("_"):
                setattr(self, k, v)

    def _rand_range(self, low=1.0, high=None, size=None):
        if high is None:
            low, high = 0, low
        if size is None:
            size = []
        return np.random.uniform(low, high, size)

    def __repr__(self) -> str:
        return self.__class__.__name__

    def __call__(self, points, info):
        raise NotImplementedError


@PROCESSORS.register()
class NoOpAugmentation(AugmentationBase):
    def __call__(self, points, info):
        return points, info


def compose_processors(processors):
    def apply(points, info):
        for p in processors:
            points, info = p(points, info)
        return points, info

    return apply
