"""Python-file configs (counterpart of pnp_vcve_tpu/core/config.py; the
surface of mmcv ``Config`` as the reference's tools use it): a config is a
Python file evaluated into a dict, with ``_base_`` inheritance, deep dict
merge, and ``--cfg-options a.b.c=v`` overrides with literal parsing (mmcv
DictAction semantics).
"""

from __future__ import annotations

import ast
import copy
import os
from pathlib import Path
from typing import Any, Dict, Mapping

__all__ = ["Config"]


class ConfigDict(dict):
    """dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj


def _deep_merge(base: Dict[str, Any], override: Mapping[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _exec_config_file(path: Path) -> Dict[str, Any]:
    ns: Dict[str, Any] = {"__file__": str(path)}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return {
        k: v
        for k, v in ns.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }


def _parse_value(text: str) -> Any:
    """DictAction-style literal parsing: int/float/bool/None/tuples/lists."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return text


class Config:
    def __init__(self, cfg_dict: Dict[str, Any], filename: str | None = None):
        object.__setattr__(self, "_cfg", ConfigDict.wrap(cfg_dict))
        object.__setattr__(self, "filename", filename)

    @classmethod
    def fromfile(cls, path: str | os.PathLike) -> "Config":
        path = Path(path)
        ns = _exec_config_file(path)
        bases = ns.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            merged = _deep_merge(merged, cls.fromfile(path.parent / b).to_dict())
        return cls(_deep_merge(merged, ns), filename=str(path))

    def merge_from_options(self, options: Mapping[str, Any]):
        """Apply ``a.b.c=value`` overrides (reference tools/train.py:48-57)."""
        for key, raw in options.items():
            value = _parse_value(raw) if isinstance(raw, str) else raw
            parts = key.split(".")
            node = self._cfg
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = ConfigDict()
                node = node[p]
            node[parts[-1]] = ConfigDict.wrap(value)

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self._cfg)

    def __getattr__(self, k):
        return getattr(object.__getattribute__(self, "_cfg"), k)

    def __getitem__(self, k):
        return self._cfg[k]

    def __contains__(self, k):
        return k in self._cfg

    def get(self, k, default=None):
        return self._cfg.get(k, default)

    def __setattr__(self, k, v):
        self._cfg[k] = ConfigDict.wrap(v)
