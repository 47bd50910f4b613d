"""Operations, bytes and least time of one msda call, from its shapes
(frozen from ``chip_smoke.py::msda_bound`` and the port's
``ops/flops.py``, with every tap counted: the shapes alone, not the
taps that a run's data puts in range).

A call takes ``value (B, N, H, D)`` and ``locations (B, Q, H, L, P, 2)``
with the attention weights ``(B, Q, H, L, P)`` and gives ``(B, Q, H*D)``.
Each input byte is read once and each output byte written once.
"""
from __future__ import annotations

import math

from .peaks import FLOPS, HBM_BYTES_PER_S

# per tap and channel: forward 4 corner FMAs and the weighted sum (10
# operations); backward the bilinear value, its x and y derivatives,
# three dot products and four scaled atomics (34)
FWD_FLOPS, BWD_FLOPS = 10, 34


def flops(value_shape, loc_shape, backward: bool = False) -> int:
    taps = math.prod(loc_shape[:-1])
    return taps * value_shape[-1] * (BWD_FLOPS if backward else FWD_FLOPS)


def nbytes(value_shape, loc_shape, backward: bool = False,
           value_bytes: int = 4) -> int:
    """Forward: value, locations and weights in, the output out. Backward:
    the same and the output's gradient (float32) in; the gradients of the
    value, the locations and the weights out."""
    B, N, H, D = value_shape
    _, Q, _, L, P, _ = loc_shape
    value = B * N * H * D * value_bytes
    loc_attn = B * Q * H * L * P * 3 * 4
    if backward:
        return 2 * value + 2 * loc_attn + B * Q * H * D * 4
    return value + loc_attn + B * Q * H * D * value_bytes


def bound_s(value_shape, loc_shape, backward: bool = False,
            value_bytes: int = 4) -> float:
    """Least time of the call on the chip: bytes over the HBM rate against
    operations over the float32 rate (msda runs outside the tensor
    cores)."""
    return max(nbytes(value_shape, loc_shape, backward, value_bytes)
               / HBM_BYTES_PER_S,
               flops(value_shape, loc_shape, backward) / FLOPS["float32"])
