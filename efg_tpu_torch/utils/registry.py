"""Name → object registry with decorator registration (a copy of
`efg_tpu/utils/registry.py`): duplicate detection, decorator or direct
registration, and `get` with a helpful error."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    """A registry mapping names to objects (classes or functions).

    Usage::

        PROCESSORS = Registry("processors")

        @PROCESSORS.register()
        class RandomFlip3D: ...

        PROCESSORS.register(name="flip")(RandomFlip3D)
        PROCESSORS.get("RandomFlip3D")
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in '{self._name}' registry!"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, name: Optional[str] = None):
        """Register `obj` (or use as a decorator when obj is None)."""
        if obj is None:
            def deco(func_or_class: Any) -> Any:
                self._do_register(name or func_or_class.__name__, func_or_class)
                return func_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f"Available: {sorted(self._obj_map.keys())}"
            )
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()

    def __len__(self) -> int:
        return len(self._obj_map)

    def __repr__(self) -> str:
        rows = "\n".join(f"  {k}: {v!r}" for k, v in sorted(self._obj_map.items()))
        return f"Registry of {self._name}:\n{rows}"
