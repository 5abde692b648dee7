"""Attribute-access dict wrapper (OmegaConf-style access for plain dicts)."""
from __future__ import annotations

from typing import Any, Dict


class DotDict(dict):
    """dict with recursive attribute access: cfg.params.tiling.tile_size."""

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict) and not isinstance(obj, cls):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, DotDict):
            return obj
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v):
            if isinstance(v, DotDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)
