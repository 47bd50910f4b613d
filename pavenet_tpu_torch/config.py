"""Python-file configs with ``_base_`` inheritance (the surface of
``pavenet_tpu/config.py`` that the port reads).

A config is a python file whose top-level variables form a dict; ``_base_``
lists parent files that are deep-merged (child wins) and ``_delete_=True``
inside a dict drops the inherited value. ``resolve_act_dtype`` reads the
model's activation dtype from a config (the JAX package keeps it in its
``models/builder.py``).
"""
from __future__ import annotations

import copy
import importlib.util
import os
import sys
import types
from typing import Any, Dict, Optional

import torch

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


class ConfigDict(dict):
    """dict with attribute access, used for every nested mapping."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Deep-merge dict ``a`` (child) into ``b`` (base)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict):
            if k in b and not v.pop(DELETE_KEY, False):
                if not isinstance(b[k], dict):
                    raise TypeError(
                        f"cannot merge dict into non-dict for key '{k}'; "
                        f"add `{DELETE_KEY}=True` to override")
                b[k] = _merge_a_into_b(v, b[k])
            else:
                b[k] = copy.deepcopy(v)
                if isinstance(b[k], dict):
                    b[k].pop(DELETE_KEY, None)
        else:
            b[k] = v
    return b


def _load_py_file(filename: str) -> Dict[str, Any]:
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    spec = importlib.util.spec_from_file_location(
        "_pavenet_torch_cfg_" + os.path.basename(filename).replace(".", "_"),
        filename)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        cfg_dict = {
            k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(
                v, (types.ModuleType, types.FunctionType, type))
        }
    finally:
        del sys.modules[spec.name]
    return copy.deepcopy(cfg_dict)


def _file2dict(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    cfg_dict = _load_py_file(filename)
    base_files = cfg_dict.pop(BASE_KEY, [])
    if isinstance(base_files, str):
        base_files = [base_files]
    base_dict: Dict[str, Any] = {}
    for base in base_files:
        parent = _file2dict(os.path.join(os.path.dirname(filename), base))
        dup = set(base_dict) & set(parent)
        if dup:
            raise KeyError(f"duplicate keys in _base_ configs: {dup}")
        base_dict.update(parent)
    return _merge_a_into_b(cfg_dict, base_dict)


class Config(ConfigDict):
    """A loaded config: a ``ConfigDict`` of the file's merged variables."""

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_to_config_dict(_file2dict(filename)))


_DTYPE_NAMES = {
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def resolve_act_dtype(cfg, override: Optional[str] = None) -> torch.dtype:
    """The model's activation dtype (as ``pavenet_tpu/models/builder.py::
    resolve_act_dtype``): ``override`` ('f32'/'bf16' and their long names)
    wins; None or 'auto' falls back to the config's top-level ``act_dtype``
    key, then float32. An unknown name raises ``KeyError``."""
    if override and override != "auto":
        return _DTYPE_NAMES[override]
    name = (cfg or {}).get("act_dtype", "float32")
    return _DTYPE_NAMES[str(name)]
