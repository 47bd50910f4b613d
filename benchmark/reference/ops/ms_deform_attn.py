"""Multi-scale deformable attention, plain: one bilinear, zero-padded
``grid_sample`` per level; its gradient is autograd through it.

- ``value``: ``(B, N, H, D)``, ``N = sum_l H_l * W_l``
- ``spatial_shapes``: ``((H_0, W_0), ...)``
- ``sampling_locations``: ``(B, Q, H, L, P, 2)``, xy in ``[0, 1]`` per level
- ``attention_weights``: ``(B, Q, H, L, P)``, already softmaxed
- pixel centres at ``loc * (W, H) - 0.5``; out-of-range corners count zero
- output: ``(B, Q, H * D)``

``record_calls()`` collects the shapes of every call made inside it (the
benchmark's cost model reads them).
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F

_calls = None


@contextlib.contextmanager
def record_calls():
    """Yield a list that gets ``(value_shape, locations_shape)`` of every
    call in the block."""
    global _calls
    outer, _calls = _calls, []
    try:
        yield _calls
    finally:
        _calls = outer


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if _calls is not None:
        _calls.append((tuple(value.shape), tuple(sampling_locations.shape)))
    B, _, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * sampling_locations - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * H, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (BH,Q,P,2)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))     # (BH,D,Q,P)
    a = attention_weights.transpose(1, 2).reshape(B * H, 1, Q, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)  # (BH,D,Q)
    return out.view(B, H * D, Q).transpose(1, 2).contiguous()
