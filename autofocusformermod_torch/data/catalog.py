"""Dataset and metadata catalogs: a dataset is registered by name as a
function that returns its list of sample dicts; metadata is an attribute bag
per name.

Counterpart of ``autofocusformermod_tpu/data/catalog.py`` (detectron2's
``DatasetCatalog`` / ``MetadataCatalog`` surface).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if name in self._registry:
            raise KeyError(f"dataset '{name}' already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(
                f"dataset '{name}' not registered; available: {sorted(self._registry)[:20]}")
        return self._registry[name]()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name, None)


class Metadata:
    """Attribute bag of one dataset."""

    def __init__(self, name: str):
        object.__setattr__(self, "name", name)

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            object.__setattr__(self, k, v)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._metas: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._metas:
            self._metas[name] = Metadata(name)
        return self._metas[name]

    def list(self) -> List[str]:
        return sorted(self._metas)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
