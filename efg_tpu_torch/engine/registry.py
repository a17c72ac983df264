"""Engine registries (port of `efg_tpu/engine/registry.py`): the trainers
(`DefaultTrainer` registers itself) and the hooks (empty, as in efg_tpu)."""

from efg_tpu_torch.utils.registry import Registry

TRAINERS = Registry("trainers")
HOOKS = Registry("hooks")
