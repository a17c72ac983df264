"""The data pipeline (port of `efg_tpu/data`): datasets, processors,
samplers and the fixed-shape loader. Importing the package registers the
ported datasets, processors and samplers."""

from efg_tpu_torch.data.builder import build_dataloader, build_dataset, build_processors
from efg_tpu_torch.data.registry import DATASETS, PROCESSORS, SAMPLERS

# trigger registrations
from efg_tpu_torch.data.processors import base as _base  # noqa: F401
from efg_tpu_torch.data.processors import extend_3d as _e3d  # noqa: F401
from efg_tpu_torch.data.processors import basic_2d as _b2d  # noqa: F401
from efg_tpu_torch.data.samplers import dataset_sampler as _ds  # noqa: F401
from efg_tpu_torch.data.datasets import synthetic as _synth  # noqa: F401
from efg_tpu_torch.data.datasets import waymo as _waymo  # noqa: F401
from efg_tpu_torch.data.datasets import nuscenes as _nuscenes  # noqa: F401
from efg_tpu_torch.data.datasets import synthetic_tracking as _synth_track  # noqa: F401
from efg_tpu_torch.data.datasets import waymo_tracking as _waymo_track  # noqa: F401
from efg_tpu_torch.data.datasets import coco as _coco  # noqa: F401

__all__ = [
    "DATASETS", "PROCESSORS", "SAMPLERS",
    "build_dataset", "build_dataloader", "build_processors",
]
