"""Config system: executable Python config files + typed override merge.

Counterpart of `vsc22_tpu/utils/config.py`, copied: it is stdlib only, but
importing the JAX module would run the JAX package's `__init__`.

`Config` wraps a nested dict with attribute access, `Config.fromfile` execs
a Python file and collects its module-level names, and `merge_flags` folds
flat `key=value` overrides (dots descend) on top -- one typed tree covering
both tiers of the reference's configuration (mmcv `Config.fromfile` over
executable Python files, plus argparse runtime flags).
"""

from __future__ import annotations

import ast
import types
from pathlib import Path
from typing import Any, Dict, Mapping, Optional


class Config:
    """Attribute-accessible nested config."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self[k] = v

    # -- mapping interface ------------------------------------------------
    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        self._data[key] = value

    def __contains__(self, key):
        return key in self._data

    def __getattr__(self, key):
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def get(self, key, default=None):
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, Config) else v for k, v in self._data.items()
        }

    def __repr__(self):
        return f"Config({self.to_dict()})"

    def __eq__(self, other):
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    # -- construction ------------------------------------------------------
    @classmethod
    def fromfile(cls, path: str) -> "Config":
        """Exec a Python config file; module-level names become keys."""
        path = Path(path)
        source = path.read_text()
        module = types.ModuleType(path.stem)
        module.__dict__["__file__"] = str(path)
        exec(compile(source, str(path), "exec"), module.__dict__)
        data = {
            k: v
            for k, v in module.__dict__.items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and not callable(v)
        }
        return cls(data)

    def merge_flags(self, flags: Mapping[str, str]) -> "Config":
        """Fold 'a.b.c=value' overrides on top (values literal-eval'd)."""
        out = Config(self.to_dict())
        for key, raw in flags.items():
            try:
                value = ast.literal_eval(raw) if isinstance(raw, str) else raw
            except (ValueError, SyntaxError):
                value = raw
            node = out
            parts = key.split(".")
            for part in parts[:-1]:
                if part not in node or not isinstance(node[part], Config):
                    node[part] = Config()
                node = node[part]
            node[parts[-1]] = value
        return out


def parse_override_args(args) -> Dict[str, str]:
    """['a.b=1', 'c=x'] -> {'a.b': '1', 'c': 'x'} (for argparse REMAINDER)."""
    out = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override {arg!r} is not key=value")
        k, v = arg.split("=", 1)
        out[k.lstrip("-")] = v
    return out
