"""Registry of config ``type`` strings (as ``pavenet_tpu/registry.py``):
a string -> class map, any known scope prefix (``'opera.'``, ``'mmdet.'``)
ignored, and ``build`` from a config dict. The port registers only what it
has: the datasets of ``datasets/``."""
from __future__ import annotations

from typing import Any, Dict

from .models.builder import split_scope_key


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

    def build(self, cfg: dict):
        """``get(cfg['type'])(**cfg_without_type)``."""
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"cfg must be a dict with a 'type' key, got "
                            f"{cfg!r}")
        args = dict(cfg)
        obj_type = args.pop("type")
        cls = self.get(obj_type) if isinstance(obj_type, str) else obj_type
        if cls is None:
            raise KeyError(f"{obj_type} is not registered in the {self.name}"
                           f" registry; known: {sorted(self.module_dict)}")
        return cls(**args)


DATASETS = Registry("datasets")
