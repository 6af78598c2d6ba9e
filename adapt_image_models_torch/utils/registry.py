"""Minimal registry: maps a string ``type`` name to a callable.

Mirrors the capability of mmcv's Registry/build_from_cfg pattern used
throughout the reference (``mmaction/models/builder.py``,
``mmaction/datasets/builder.py:21-23``) without importing mmcv. Configs are
plain dicts with a ``type`` key; everything else is passed as kwargs.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Callable]:
        return dict(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None, force: bool = False):
        """Register a class/function. Usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str], force: bool):
        if not callable(module):
            raise TypeError(f"module must be callable, got {type(module)}")
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_kwargs):
        return build_from_cfg(cfg, self, **default_kwargs)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, **default_kwargs):
    """Instantiate ``registry[cfg['type']](**cfg_without_type)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}. "
                           f"Available: {sorted(registry.module_dict)}")
    elif callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or callable, got {type(obj_type)}")
    for k, v in default_kwargs.items():
        args.setdefault(k, v)
    try:
        return obj_cls(**args)
    except TypeError as e:
        raise TypeError(f"building {obj_cls.__name__} from {registry.name}: {e}") from e
