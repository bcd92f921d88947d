"""Component registry (counterpart of ``utils/registry.py``): five
namespaces, decorator-based registration.

``trainer``, ``env``, ``policy``, ``vo_model``, ``vo_engine``; importing
``pointnav_vo_tpu_torch.engines`` populates them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Dict[str, Any]] = {
    "trainer": {},
    "env": {},
    "policy": {},
    "vo_model": {},
    "vo_engine": {},
}


def _register(namespace: str, name: Optional[str] = None) -> Callable:
    def wrap(obj):
        _REGISTRY[namespace][name or obj.__name__] = obj
        return obj

    return wrap


def register_trainer(name=None):
    return _register("trainer", name)


def register_env(name=None):
    return _register("env", name)


def register_policy(name=None):
    return _register("policy", name)


def register_vo_model(name=None):
    return _register("vo_model", name)


def register_vo_engine(name=None):
    return _register("vo_engine", name)


def get(namespace: str, name: str) -> Any:
    try:
        return _REGISTRY[namespace][name]
    except KeyError as e:
        known = sorted(_REGISTRY.get(namespace, {}))
        raise KeyError(f"{name!r} not registered in {namespace!r}; known: {known}") from e


def get_trainer(name):
    return get("trainer", name)


def get_env(name):
    return get("env", name)


def get_policy(name):
    return get("policy", name)


def get_vo_model(name):
    return get("vo_model", name)


def get_vo_engine(name):
    return get("vo_engine", name)


def names(namespace: str):
    return sorted(_REGISTRY[namespace])
