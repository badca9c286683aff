"""Name -> object registries for datasets, architectures, models, losses,
and metrics: a copy of ``tpuir/registry.py`` (BasicSR's registry,
``basicsr/utils/registry.py``, minus the import-by-filename scanning). The
registries fill when ``tpuir_torch.train`` is imported.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any, suffix: Optional[str] = None):
        if isinstance(suffix, str):
            name = name + "_" + suffix
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in '{self._name}'"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, suffix: Optional[str] = None):
        if obj is None:  # decorator usage
            def deco(fn_or_class: Any):
                self._do_register(fn_or_class.__name__, fn_or_class, suffix)
                return fn_or_class

            return deco
        self._do_register(obj.__name__, obj, suffix)
        return obj

    def get(self, name: str, suffix: str = "tpuir") -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            ret = self._obj_map.get(name + "_" + suffix)
        if ret is None:
            raise KeyError(f"No object named '{name}' found in '{self._name}' registry")
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
