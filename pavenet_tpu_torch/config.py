"""Python-file configs with ``_base_`` inheritance (the surface of
``pavenet_tpu/config.py`` that the port reads).

A config is a python file whose top-level variables form a dict; ``_base_``
lists parent files that are deep-merged (child wins) and ``_delete_=True``
inside a dict drops the inherited value; ``Config.fromstring`` reads the
text of such a file, ``pretty_text`` and ``dump`` write one (``key =
value`` lines through ``pformat_value``). ``Config.merge_from_dict`` applies
``a.b.c=value`` overrides (the CLIs' ``--cfg-options``, parsed by
``DictAction``); ``replace_cfg_vals`` substitutes ``${key}`` strings and
``update_data_root`` moves dataset paths under ``MMDET_DATASETS``.
``resolve_act_dtype`` reads the model's activation dtype from a config (the
JAX package keeps it in its ``models/builder.py``).
"""
from __future__ import annotations

import copy
import importlib.util
import os
import re
import sys
import tempfile
import types
from typing import Any, Dict, List, Optional

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

    def __deepcopy__(self, memo):
        return type(self)(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo)
             for k, v in self.items()})


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_a_into_b(a: dict, b: dict, allow_list_keys: bool = False) -> dict:
    """Deep-merge dict ``a`` (child) into ``b`` (base); with
    ``allow_list_keys`` a digit key of ``a`` indexes a list of ``b``."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if allow_list_keys and k.isdigit() and isinstance(b, list):
            k = int(k)
            if len(b) <= k:
                raise KeyError(f"index {k} exceeds list length {len(b)}")
            b[k] = _merge_a_into_b(v, b[k], allow_list_keys)
        elif isinstance(v, dict):
            if k in b and not v.pop(DELETE_KEY, False):
                if not isinstance(b[k], dict):
                    raise TypeError(
                        f"cannot merge dict into non-dict for key '{k}'; "
                        f"add `{DELETE_KEY}=True` to override")
                b[k] = _merge_a_into_b(v, b[k], allow_list_keys)
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

    @staticmethod
    def fromstring(cfg_str: str) -> "Config":
        """The config of a file's text (``_base_`` paths absolute)."""
        with tempfile.NamedTemporaryFile("w", suffix=".py",
                                         delete=False) as f:
            f.write(cfg_str)
            path = f.name
        try:
            return Config.fromfile(path)
        finally:
            os.unlink(path)

    def to_dict(self) -> dict:
        """The config as plain dicts, lists and tuples."""
        def _plain(o):
            if isinstance(o, dict):
                return {k: _plain(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(_plain(v) for v in o)
            return o
        return _plain(dict(self))

    @property
    def pretty_text(self) -> str:
        return pformat_value(self.to_dict())

    def dump(self, file: Optional[str] = None):
        """The config as ``key = value`` lines: returned, or written to
        ``file``."""
        text = "\n".join(f"{k} = {pformat_value(v)}"
                         for k, v in self.to_dict().items())
        if file is None:
            return text
        with open(file, "w") as f:
            f.write(text + "\n")

    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply ``{'a.b.c': v}``-style overrides in place; a digit key
        indexes a list."""
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split(".")
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = v
        merged = _merge_a_into_b(option_cfg, dict(self),
                                 allow_list_keys=True)
        self.clear()
        self.update(_to_config_dict(merged))


def pformat_value(v) -> str:
    import pprint
    return pprint.pformat(v, width=100, sort_dicts=False)


class DictAction:
    """Parser of ``KEY=VALUE`` config overrides: ints, floats, true/false,
    None and comma lists become Python values."""

    @staticmethod
    def parse_value(val: str):
        for fn in (int, float):
            try:
                return fn(val)
            except ValueError:
                pass
        if val.lower() in ("true", "false"):
            return val.lower() == "true"
        if val == "None":
            return None
        if "," in val or (val.startswith("[") and val.endswith("]")) or (
                val.startswith("(") and val.endswith(")")):
            inner = val.strip("[]()")
            return [DictAction.parse_value(x) for x in inner.split(",") if x]
        return val

    @staticmethod
    def parse(pairs: List[str]) -> Dict[str, Any]:
        out = {}
        for pair in pairs:
            key, _, val = pair.partition("=")
            out[key] = DictAction.parse_value(val)
        return out


_VAR_PATTERN = re.compile(r"\$\{[a-zA-Z\d_.]*\}")


def replace_cfg_vals(cfg: Config) -> Config:
    """Substitute ``"${key.path}"`` strings with config values. A string
    that is exactly one ``${...}`` takes the referenced value verbatim (any
    type); embedded occurrences are str-interpolated. A ``model_wrapper``
    key, if present, replaces ``model``."""

    def get_value(key):
        node = cfg
        for k in key.split("."):
            node = node[k]
        return node

    def replace(value):
        if isinstance(value, dict):
            return {k: replace(v) for k, v in value.items()}
        if isinstance(value, list):
            return [replace(v) for v in value]
        if isinstance(value, tuple):
            return tuple(replace(v) for v in value)
        if isinstance(value, str):
            keys = _VAR_PATTERN.findall(value)
            if not keys:
                return value
            if len(keys) == 1 and keys[0] == value:
                return get_value(keys[0][2:-1])
            for key in keys:
                sub = get_value(key[2:-1])
                if isinstance(sub, (dict, list, tuple)):
                    raise TypeError(
                        f"cannot str-interpolate {type(sub)} for {key}")
                value = value.replace(key, str(sub))
            return value
        return value

    new = Config(_to_config_dict(replace(dict(cfg))))
    if new.get("model_wrapper") is not None:
        new["model"] = new.pop("model_wrapper")
    return new


def update_data_root(cfg: Config) -> None:
    """With the environment's ``MMDET_DATASETS`` set, replace the
    ``data_root`` prefix of every string of the config by it, in place."""
    dst = os.environ.get("MMDET_DATASETS")
    if not dst or "data_root" not in cfg:
        return
    src = cfg["data_root"]

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, str) and src in v:
                d[k] = v.replace(src, dst)
    walk(cfg)
    cfg["data_root"] = dst


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
