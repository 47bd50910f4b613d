"""Checkpoints (as ``pavenet_tpu/utils/checkpoint.py``, with ``torch.save``
in place of orbax): ``<dir>/step_<N>.pt`` holds a ``TrainState.state_dict``
and a meta dict (the epoch), read back with ``torch.load(weights_only=
True)``."""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pt$")


def _checkpoints(ckpt_dir: str):
    """(step, file name) of every checkpoint in ``ckpt_dir``, by step."""
    return sorted((int(m.group(1)), name) for name in os.listdir(ckpt_dir)
                  for m in [_NAME.match(name)] if m)


def save_checkpoint(ckpt_dir: str, state, step: int,
                    meta: Optional[dict] = None, max_keep: int = 20) -> str:
    """Write ``state`` (a ``TrainState``) as ``step_<step>.pt`` and keep the
    newest ``max_keep``; returns the path. The file is written under a
    temporary name and renamed, so a cut run leaves no partial checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.pt")
    torch.save(dict(state=state.state_dict(), meta=dict(meta or {})),
               path + ".tmp")
    os.replace(path + ".tmp", path)
    _prune(ckpt_dir, max_keep)
    return path


def _prune(ckpt_dir: str, max_keep: int):
    for _, name in _checkpoints(ckpt_dir)[:-max_keep]:
        os.remove(os.path.join(ckpt_dir, name))


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1][1]) if ckpts else None


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state):
    """Load the checkpoint at ``path`` into ``state`` (a ``TrainState`` of
    the same config); returns its meta dict."""
    ckpt = _load(path)
    state.load_state_dict(ckpt["state"])
    return ckpt["meta"]


def restore_variables(path: str) -> dict:
    """The model's state dict (parameters and BatchNorm statistics) of a
    checkpoint, for inference: no optimizer is rebuilt."""
    return _load(path)["state"]["model"]
