"""Registry of config ``type`` strings (as ``pavenet_tpu/registry.py``):
a string -> class map, any known scope prefix (``'opera.'``, ``'mmdet.'``)
ignored (``split_scope_key``), and ``build`` from a config dict
(``build_from_cfg``). The port registers only what it has: the datasets of
``datasets/``."""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from .models.builder import split_scope_key

__all__ = ["Registry", "build_from_cfg", "split_scope_key", "DATASETS"]


class Registry:
    """A string -> class map used to build objects from configs."""

    def __init__(self, name: str):
        self.name = name
        self.module_dict: Dict[str, Any] = {}

    def get(self, key: str):
        """The class registered under ``key``, scope prefix ignored."""
        return self.module_dict.get(split_scope_key(key)[1])

    def register_module(self, name=None):
        """Class decorator; ``name`` is a name or a list of names (default:
        the class's)."""
        def _decorator(cls):
            names = ([cls.__name__] if name is None
                     else [name] if isinstance(name, str) else list(name))
            for n in names:
                if n in self.module_dict:
                    raise KeyError(f"{n} is already registered in "
                                   f"{self.name}")
                self.module_dict[n] = cls
            return cls
        return _decorator

    def build(self, cfg: dict, default_args: Optional[dict] = None):
        return build_from_cfg(cfg, self, default_args)


def build_from_cfg(cfg: dict, registry: Registry,
                   default_args: Optional[dict] = None):
    """``registry.get(cfg['type'])(**cfg_without_type)``, ``default_args``
    filling the keys ``cfg`` lacks; ``type`` may also be a class or a
    function."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    for k, v in (default_args or {}).items():
        args.setdefault(k, v)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        cls = registry.get(obj_type)
        if cls is None:
            raise KeyError(f"{obj_type} is not registered in the "
                           f"{registry.name} registry; known: "
                           f"{sorted(registry.module_dict)}")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    return cls(**args)


DATASETS = Registry("datasets")
