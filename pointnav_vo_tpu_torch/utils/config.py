"""Minimal yacs-style config tree (counterpart of ``utils/config.py``):
nested attribute dicts, YAML files and ``KEY VALUE`` overrides.

Freeze/defrost discipline, ``merge_from_file`` / ``merge_from_list`` CLI
passthrough, and eval configs read back out of checkpoints.  Key names
across the default trees (``config/defaults.py``) follow the reference's.
YAML is read with PyYAML's ``safe_load``, for files and override values
alike.
"""

from __future__ import annotations

import copy
import warnings
from typing import Any, Dict, Iterable, Optional

import yaml


class Config(dict):
    """Nested attribute-access dict with freeze semantics."""

    def __init__(self, init: Optional[Dict] = None, new_allowed: bool = True):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_new_allowed", new_allowed)
        if init:
            for k, v in init.items():
                self[k] = Config(v, new_allowed) if isinstance(v, dict) else v

    # -- attribute protocol --------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key, value) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"config is frozen; cannot set {key!r}")
        if not object.__getattribute__(self, "_new_allowed") and key not in self:
            raise KeyError(f"unknown config key {key!r} (new keys not allowed)")
        super().__setitem__(key, value)

    # -- freeze / clone --------------------------------------------------------

    def freeze(self) -> "Config":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def defrost(self) -> "Config":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, Config):
                v.defrost()
        return self

    def clone(self) -> "Config":
        return Config(self.to_dict())

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
                for k, v in self.items()}

    # -- merging ----------------------------------------------------------------

    def merge_from_dict(self, other: Dict) -> "Config":
        for k, v in other.items():
            if isinstance(v, dict):
                node = self.get(k)
                if not isinstance(node, Config):
                    self[k] = Config(v)
                else:
                    node.merge_from_dict(v)
            else:
                self[k] = copy.deepcopy(v)
        return self

    def merge_from_file(self, path: str) -> "Config":
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable) -> "Config":
        """Alternating ``[key, value, key, value, ...]`` CLI overrides (the
        reference's CMD_TRAILING_OPTS); string values parse as YAML."""
        opts = list(opts)
        if len(opts) % 2:
            raise ValueError("override list must alternate key/value")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                # the trees take new keys (reference semantics), so a typo'd
                # override would otherwise make a silently inert key
                warnings.warn(f"config override creates NEW key {key!r} — "
                              "check for a typo", stacklevel=2)
            if isinstance(value, str):
                value = yaml.safe_load(value)
            node[leaf] = value
        return self

    def __deepcopy__(self, memo):
        return Config(self.to_dict())

    def __str__(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True, default_flow_style=False)
