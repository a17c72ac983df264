from efg_tpu_torch.engine.registry import HOOKS, TRAINERS

__all__ = ["TRAINERS", "HOOKS"]
