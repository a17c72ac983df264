"""YAML configuration: default.yaml ← experiment config ← CLI dotlist
(port of `efg_tpu/config`)."""

from efg_tpu_torch.config.config import Config, Configuration, load_yaml, merge_dict

__all__ = ["Config", "Configuration", "load_yaml", "merge_dict"]
