"""Open parameter bag for trainer and aggregator hooks (copy of
``fedml_tpu/core/alg_frame/params.py``): attribute- and key-style access
over one dict."""

from __future__ import annotations

from typing import Any, Dict


class Params:
    KEY_MODEL_PARAMS = "model_params"

    def __init__(self, **kwargs: Any):
        self.__dict__["_store"]: Dict[str, Any] = dict(kwargs)

    def add(self, name: str, value: Any) -> "Params":
        self._store[name] = value
        return self

    def get(self, name: str, default: Any = None) -> Any:
        return self._store.get(name, default)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["_store"][name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self._store[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def keys(self):
        return self._store.keys()

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._store)
