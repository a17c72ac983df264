"""Data registries (port of `efg_tpu/data/registry.py`)."""

from efg_tpu_torch.utils.registry import Registry

DATASETS = Registry("datasets")
SAMPLERS = Registry("samplers")
PROCESSORS = Registry("processors")
