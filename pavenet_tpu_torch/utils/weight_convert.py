"""JAX variables -> the port's ``state_dict``, and the port's BatchNorm
statistics back to the JAX ``batch_stats`` layout.

The port names its modules after the JAX parameter tree, so the conversion
is a walk over the tree: the path becomes the dotted key and each leaf is
renamed and laid out by fixed rules:

- Dense ``kernel (in, out)`` -> ``weight (out, in)``
- Conv ``kernel`` HWIO -> ``weight`` OIHW
- attention ``query/key/value`` ``kernel (C, H, D)`` -> ``weight (H*D, C)``,
  ``bias (H, D)`` -> ``(H*D,)``; ``out`` ``kernel (H, D, C)`` ->
  ``weight (C, H*D)``
- norm ``scale`` -> ``weight``; ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var`` (flax ``BatchNorm`` and the JAX
  ``FrozenBatchNorm`` alike; the port's norms keep no
  ``num_batches_tracked``)
- free parameters (embeddings, Swin's ``relative_position_bias_table``)
  keep their names and layout.

The fused per-frame ``sampling_offsets``/``attention_weights`` Dense layers
stay one Linear, output order unchanged. The RealNVP flows (``enc_flow``,
``dec_flow``, ``flow``), PETR's heatmap branch (``head.fc_hm``,
``head.hm_encoder_layer``), HRNet's modules (``stem1/conv``,
``stage{s}_module{m}/branch{b}_block{k}``, ``fuse{i}_{j}_conv/bn``,
``fuse{i}_{j}_down{t}``, ``transition{s}_{b}``) and SOIT's and DK-DETR's
top-level tree (``encoder_layer{i}``, ``seg_encoder_layer``,
``mask_trans(_norm)``, ``enc_output(_norm)``, ``pos_trans(_norm)``,
``dec_self_attn{i}``, ``dec_cross_attn{i}``, ``dec_norm{1,2,3}_{i}``,
``dec_ffn{i}``, ``cls_branch{i}``, ``reg_branch{i}``, ``seg_branch{i}``,
``level_embeds``; a SOIT init makes no train-only subtree) and InsPose's
(the FPN's ``lateral{i}``, ``fpn{i}``, ``fpn_extra{j}``; ``ConvGN``'s
``Conv_0`` and ``GroupNorm_0``; ``DeformConvGN``'s Dense ``kernel`` over
the tap-major patches, ``(9C, F)`` -> ``Linear`` ``(F, 9C)``) convert like
any other tree.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# subtrees a JAX init makes only in train mode: the flows, and PETR's
# heatmap branch
FLOWS = ("enc_flow", "dec_flow", "flow")
TRAIN_ONLY = FLOWS + ("fc_hm", "hm_encoder_layer")
FREE_PARAMS = frozenset({"level_embeds", "query_embedding",
                         "refine_query_embedding",
                         "relative_position_bias_table"})
STATS = {"mean": "running_mean", "var": "running_var"}


def _param(path, leaf: np.ndarray):
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name in FREE_PARAMS:
        return name, leaf
    if name == "scale":
        return "weight", leaf
    if name == "bias":
        return "bias", leaf.reshape(-1)
    if name != "kernel":
        raise KeyError(f"unknown JAX leaf {'/'.join(path)}")
    if leaf.ndim == 2:
        return "weight", leaf.T
    if leaf.ndim == 4:
        return "weight", leaf.transpose(3, 2, 0, 1)
    if leaf.ndim == 3 and parent == "out":      # (H, D, C)
        return "weight", leaf.reshape(-1, leaf.shape[-1]).T
    if leaf.ndim == 3:                          # (C, H, D)
        return "weight", leaf.reshape(leaf.shape[0], -1).T
    raise KeyError(f"unexpected kernel rank at {'/'.join(path)}: "
                   f"{leaf.shape}")


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of numpy (or array-like)
    leaves -> ``state_dict`` for ``load_state_dict(strict=True)``."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown JAX collections {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables.get("params", {})):
        name, arr = _param(path, leaf)
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        if path[-1] not in STATS:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (STATS[path[-1]],))] = torch.from_numpy(
            np.ascontiguousarray(leaf, dtype=np.float32))
    return out


def load_jax_variables(model: nn.Module, variables: Mapping):
    """Load a converted JAX tree into ``model``. A serving-only tree (a JAX
    init with ``train=False``) has no flows and no heatmap branch: the keys
    of those subtrees (``TRAIN_ONLY``) may be missing and keep the model's
    own init. Any other missing or unexpected key raises.
    """
    result = model.load_state_dict(jax_variables_to_state_dict(variables),
                                   strict=False)
    missing = [k for k in result.missing_keys
               if not any(f".{f}." in f".{k}" for f in TRAIN_ONLY)]
    if missing or result.unexpected_keys:
        raise KeyError(f"JAX variables do not fit the model: missing "
                       f"{missing}, unexpected {result.unexpected_keys}")


def batch_stats_to_numpy(model: nn.Module) -> Dict:
    """The model's BatchNorm statistics as a JAX ``batch_stats`` tree of
    numpy float32 arrays (``{'backbone': {'layer2_0': {'bn1': {'mean': ...,
    'var': ...}}}}``), the reverse of the ``batch_stats`` half of
    :func:`jax_variables_to_state_dict`."""
    names = {v: k for k, v in STATS.items()}
    tree: Dict = {}
    for key, buf in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf not in names:
            continue
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[names[leaf]] = buf.detach().float().cpu().numpy()
    return tree
