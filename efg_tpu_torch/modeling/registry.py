"""Modeling registries (port of `efg_tpu/modeling/registry.py`)."""

from efg_tpu_torch.utils.registry import Registry

BACKBONES = Registry("backbones")
READERS = Registry("readers")
HEADS = Registry("heads")
LOSSES = Registry("losses")
LAYERS = Registry("layers")
