"""Dataset and metadata catalogs: string-keyed registries.

Counterpart of ``sos_wsod_tpu/data/catalog.py`` (detectron2's DatasetCatalog
and MetadataCatalog). A dataset registers a function that returns its list of
dataset dicts; its metadata holds class names, directory, year and split.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]):
        assert callable(func)
        if name in self._registry:
            raise KeyError(f"Dataset '{name}' already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(f"Dataset '{name}' not registered. Available: {sorted(self._registry)}")
        return self._registry[name]()

    def list(self):
        return sorted(self._registry)

    def remove(self, name: str):
        self._registry.pop(name, None)

    def clear(self):
        self._registry.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class _Metadata(types.SimpleNamespace):
    def get(self, key, default=None):
        return getattr(self, key, default)

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._registry:
            self._registry[name] = _Metadata(name=name)
        return self._registry[name]

    def list(self):
        return sorted(self._registry)

    def clear(self):
        self._registry.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
