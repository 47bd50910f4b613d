"""Operation counts of the functions the hand-written kernels compute, for
``tools/get_flops.py`` and the bounds of ``chip_smoke.py``.

The kernels run through ctypes, where ``torch.utils.flop_counter`` cannot
see them, so their operations are counted from each call's shapes: an
add and a multiply count two, an FMA two, as the torch counter counts a
product. Inside ``kernel_flops()`` each call of ``ms_deform_attn`` and
``window_attention_levels`` adds its count to the tally, and their plain
versions (CPU tensors) run outside any torch counter, so that no operation
counts twice and the CPU and the card count alike.
"""
from __future__ import annotations

import contextlib
import math

# msda, per tap and channel, corner weights counted once per tap: forward 4
# corner FMAs and the weighted sum; backward the bilinear value, its x and y
# derivatives, three dot products and four scaled atomics
MSDA_FWD_FLOPS, MSDA_BWD_FLOPS = 10, 34
# window attention: products of (S, S, C) per window, forward the scores and
# the values, backward five
WINDOW_PRODUCTS = {False: 2, True: 5}

_tally = None


def msda_flops(taps: int, channels: int, backward: bool = False) -> int:
    """Operations of msda over ``taps`` bilinear taps of ``channels``
    channels each."""
    return taps * channels * (MSDA_BWD_FLOPS if backward else MSDA_FWD_FLOPS)


def window_flops(shapes, window=(8, 16), backward: bool = False) -> int:
    """Operations of one window-attention call over padded level rasters of
    ``shapes`` ``(B, Hp, Wp, C)``: every window counts, masked or not."""
    S = window[0] * window[1]
    flops = 0
    for B, Hp, Wp, C in shapes:
        windows = B * (Hp // window[0]) * (Wp // window[1])
        flops += windows * WINDOW_PRODUCTS[backward] * 2 * S * S * C
    return flops


@contextlib.contextmanager
def kernel_flops():
    """Tally the forward operations of every msda and window-attention call
    in the block: yields ``{'msda': flops, 'msda_calls': n,
    'window_attn': flops, 'window_attn_calls': n}``, every tap and window
    of each call's shapes counted."""
    global _tally
    outer, _tally = _tally, dict(msda=0, msda_calls=0, window_attn=0,
                                 window_attn_calls=0)
    try:
        yield _tally
    finally:
        _tally = outer


def record_msda(value, locations):
    """Count one msda call (``value (B, N, H, D)``, ``locations (B, Q, H,
    L, P, 2)``) in the active tally."""
    if _tally is not None:
        _tally["msda"] += msda_flops(math.prod(locations.shape[:-1]),
                                     value.shape[-1])
        _tally["msda_calls"] += 1


def record_window(qs, window):
    """Count one window-attention call over the rasters ``qs``."""
    if _tally is not None:
        _tally["window_attn"] += window_flops([q.shape for q in qs], window)
        _tally["window_attn_calls"] += 1


def outside_counter():
    """Inside ``kernel_flops()``: a context in which no torch dispatch mode
    (the flop counter) sees the operations; elsewhere nothing."""
    if _tally is None:
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()
