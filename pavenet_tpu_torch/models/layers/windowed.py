"""Windowed encoder layer (as ``pavenet_tpu/models/layers/windowed.py``):
dense attention inside non-overlapping (8, 16)-token windows of each pyramid
level, in place of the deformable encoder layer (``encoder_mode=
'windowed'``).

As in the JAX package:

- q and k are projected from ``x + pos``, v from ``x``; v is zeroed at
  padded keys, so a fully padded window attends to zeros;
- odd layers (``shift=True``) roll the level raster by half a window,
  ``(-(wh // 2), -(ww // 2))``, before padding it to window multiples, and
  roll the cropped output back. The roll wraps around the image edges with
  no Swin region mask: keys that wrap in are masked only where they are
  padding;
- dropout after the output projection, post-norm, then the FFN and a
  second norm;
- in ``dtype`` (``layers/dtype.py``): the projections, the attention's
  inputs and output, and the LayerNorms' outputs; the scores and softmax
  in float32, the weights cast to ``dtype`` before ``A V``.

Attention goes through ``ops/window_attn.py`` on the rasters, for every
``impl`` (the plain version partitions into windows inside it): one call
per layer takes all pyramid levels, so the kernels launch once per layer
and direction. Roll, pad and crop stay here, as in the JAX layer.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.window_attn import window_attention_levels
from .dtype import LayerNorm, Linear
from .transformer import FFN, Dropout

WINDOW = (8, 16)   # (wh, ww): 128 tokens


def _padded(Hl: int, Wl: int, wh: int, ww: int) -> Tuple[int, int]:
    return -(-Hl // wh) * wh, -(-Wl // ww) * ww


def window_partition(x, Hl, Wl, wh=WINDOW[0], ww=WINDOW[1], shift=False):
    """(B, Hl*Wl, ...) raster -> (B * nW, wh*ww, ...) windows; ``shift``
    rolls the raster by half a window first."""
    B, trail = x.shape[0], x.shape[2:]
    x = x.reshape(B, Hl, Wl, *trail)
    if shift:
        x = torch.roll(x, (-(wh // 2), -(ww // 2)), dims=(1, 2))
    Hp, Wp = _padded(Hl, Wl, wh, ww)
    x = F.pad(x, (0, 0) * len(trail) + (0, Wp - Wl, 0, Hp - Hl))
    x = x.reshape(B, Hp // wh, wh, Wp // ww, ww, *trail).transpose(2, 3)
    return x.reshape(-1, wh * ww, *trail)


def window_unpartition(w, B, Hl, Wl, wh=WINDOW[0], ww=WINDOW[1],
                       shift=False):
    """Inverse of :func:`window_partition` -> (B, Hl*Wl, ...)."""
    trail = w.shape[2:]
    Hp, Wp = _padded(Hl, Wl, wh, ww)
    x = w.reshape(B, Hp // wh, Wp // ww, wh, ww, *trail).transpose(2, 3)
    x = x.reshape(B, Hp, Wp, *trail)[:, :Hl, :Wl]
    if shift:
        x = torch.roll(x, (wh // 2, ww // 2), dims=(1, 2))
    return x.reshape(B, Hl * Wl, *trail)


def _attend_levels(q, k, v, key_padding_mask, spatial_shapes, num_heads,
                   wh=WINDOW[0], ww=WINDOW[1], shift=False, impl="auto"):
    """Window attention on every level's raster in one call: (B, N, C) q,
    k, v over the concatenated levels (v already zeroed at padded keys) ->
    (B, N, C)."""
    B, N, C = q.shape
    keep = (torch.ones(B, N, dtype=torch.float32, device=q.device)
            if key_padding_mask is None else (~key_padding_mask).float())
    levels, start = [], 0
    for Hl, Wl in spatial_shapes:
        sl = slice(start, start + Hl * Wl)
        rasters = [x[:, sl].reshape(B, Hl, Wl, -1)
                   for x in (q, k, v, keep[..., None])]
        if shift:
            rasters = [torch.roll(x, (-(wh // 2), -(ww // 2)), dims=(1, 2))
                       for x in rasters]
        Hp, Wp = _padded(Hl, Wl, wh, ww)
        levels.append([F.pad(x, (0, 0, 0, Wp - Wl, 0, Hp - Hl))
                       for x in rasters])
        start += Hl * Wl
    qs, ks, vs, keeps = zip(*levels)
    outs = window_attention_levels(qs, ks, vs, [x[..., 0] for x in keeps],
                                   num_heads, wh, ww, impl=impl)
    cropped = []
    for out, (Hl, Wl) in zip(outs, spatial_shapes):
        out = out[:, :Hl, :Wl]
        if shift:
            out = torch.roll(out, (wh // 2, ww // 2), dims=(1, 2))
        cropped.append(out.reshape(B, Hl * Wl, C))
    return torch.cat(cropped, 1)


class WindowedEncoderLayer(nn.Module):
    """Drop-in for the deformable ``EncoderLayer``: same call, and the
    deformable ``reference_points`` argument is ignored."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024, dropout: float = 0.1,
                 shift: bool = False, impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = embed_dims
        self.num_heads, self.shift, self.impl = num_heads, shift, impl
        self.q_proj = Linear(C, C, dtype=dtype)
        self.k_proj = Linear(C, C, dtype=dtype)
        self.v_proj = Linear(C, C, dtype=dtype)
        self.out_proj = Linear(C, C, dtype=dtype)
        self.drop = Dropout(dropout)
        self.norm1 = LayerNorm(C, dtype=dtype)
        self.ffn = FFN(C, feedforward_channels, dropout, dtype)
        self.norm2 = LayerNorm(C, dtype=dtype)

    def forward(self, x, pos, reference_points, spatial_shapes: Sequence,
                key_padding_mask):
        qk = x if pos is None else x + pos
        q, k = self.q_proj(qk), self.k_proj(qk)
        v = self.v_proj(x)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        out = _attend_levels(q, k, v, key_padding_mask, spatial_shapes,
                             self.num_heads, *WINDOW, shift=self.shift,
                             impl=self.impl)
        out = self.drop(self.out_proj(out))
        return self.norm2(self.ffn(self.norm1(x + out)))
