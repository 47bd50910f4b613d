"""Random weights from the run's seed, made on the device in one draw.

``make_state_dict(shapes, seed, device)`` draws one float32 normal vector
for every floating entry of the state dict together, with a
``torch.Generator`` on ``device``, and cuts it into the entries, each
scaled by a rule on its name and shape. The same seed and shapes on the
same device give the same weights; ``program.seed_weights`` draws them
once from the reference's state dict and loads the one dict into the
program and into the reference. The rules keep the layers in their
working range: LeCun scale on kernels, unit norms, the classifier's prior
bias, deformable sampling offsets a few pixels wide.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

# the classification prior of the pose heads (mmdet ``bias_init_with_prob
# (0.01)``): sigmoid(-4.595) = 0.01
CLS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def _rule(name: str, shape: Tuple[int, ...]):
    """(scale, offset) of the entry ``name``: value = offset + scale * z."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 0.1, 1.0
    if leaf == "running_mean":
        return 0.1, 0.0
    if "cls_branch" in name and leaf == "bias":
        return 0.0, CLS_PRIOR_BIAS
    if "sampling_offsets" in name and leaf == "bias":
        return 2.0, 0.0                       # pixels of each level
    if name.endswith(("level_embeds", "query_embedding")):
        return 1.0, 0.0
    if len(shape) >= 2:                       # kernels: LeCun normal
        fan_in = math.prod(shape[1:])
        return 1.0 / math.sqrt(fan_in), 0.0
    if leaf == "weight":                      # norm scales
        return 0.1, 1.0
    return 0.02, 0.0                          # biases, tables


def shapes_of(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...],
                                                         torch.dtype]]:
    """Name -> (shape, dtype) of the state dict's entries."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in model.state_dict().items()}


def make_state_dict(shapes: Mapping, seed: int, device) -> dict:
    """The floating entries of ``shapes`` (``shapes_of``), drawn from
    ``seed`` on ``device``; integer entries (BatchNorm's counters) are
    left out."""
    names = [k for k, (_, dt) in shapes.items() if dt.is_floating_point]
    sizes = [math.prod(shapes[k][0]) for k in names]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        shape = shapes[name][0]
        scale, offset = _rule(name, shape)
        v = part.view(shape).mul_(scale).add_(offset)
        if name.endswith("running_var"):
            v.abs_()
        out[name] = v
    return out
