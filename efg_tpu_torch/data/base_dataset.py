"""Dataset base class (a copy of `efg_tpu/data/base_dataset.py`)."""

from __future__ import annotations

from typing import Any, List, Tuple

from efg_tpu_torch.data.processors.base import compose_processors


class BaseDataset:
    def __init__(self, config):
        self.config = config
        self.transforms: List[Any] = []

    def _apply_transforms(self, points, info) -> Tuple[Any, dict]:
        return compose_processors(self.transforms)(points, info)

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError
