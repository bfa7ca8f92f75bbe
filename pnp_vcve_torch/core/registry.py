"""Name -> constructor registry (counterpart of pnp_vcve_tpu/core/registry.py;
reference: mmedit registries built on mmcv ``build_from_cfg``). Reference
type names are registered as aliases so existing config files keep working."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["Registry"]


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, Callable] = {}

    def register(self, obj: Optional[Callable] = None, *, name=None, aliases=()):
        def deco(o):
            for n in (name or o.__name__, *aliases):
                if n in self._map:
                    raise KeyError(f"{n!r} already registered in {self.name}")
                self._map[n] = o
            return o

        return deco(obj) if obj is not None else deco

    def get(self, name: str) -> Callable:
        if name not in self._map:
            raise KeyError(
                f"{name!r} not found in registry {self.name}; known: {sorted(self._map)}"
            )
        return self._map[name]

    def build(self, cfg: dict, **extra) -> Any:
        """Instantiate from a ``{'type': name, ...kwargs}`` dict."""
        cfg = dict(cfg)
        return self.get(cfg.pop("type"))(**cfg, **extra)

    def __contains__(self, name: str) -> bool:
        return name in self._map
