"""Name -> class/function registries, as the JAX package's `registry.py`.

Only the registries this port fills so far: datasets, metrics, models and
losses.
Registration is by explicit decorators; each package's __init__ imports its
modules so the decorators run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A simple name -> object registry with decorator-based registration."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, name: str | None = None) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            key = name or obj.__name__
            if key in self._obj_map:
                raise KeyError(f"{key!r} already registered in {self._name} registry")
            self._obj_map[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"{name!r} not found in {self._name} registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()


DATASET_REGISTRY = Registry("dataset")
MODEL_REGISTRY = Registry("model")
METRIC_REGISTRY = Registry("metric")
LOSS_REGISTRY = Registry("loss")
