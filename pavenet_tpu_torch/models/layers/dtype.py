"""Layers computed in an activation dtype, as flax's ``dtype=`` argument
computes them (the JAX package's bf16 model path).

Parameters stay float32. ``Linear`` and ``Conv2d`` cast their input and
their parameters to ``dtype`` and return ``dtype`` (flax ``Dense`` and
``Conv``); ``LayerNorm`` and ``GroupNorm`` take their statistics and the
affine in float32 and return ``dtype`` (flax's norms promote to at least
float32, then cast the result). Everything else follows PyTorch's type
promotion, which agrees with JAX's where the model meets it: a bf16 tensor
with a float32 one gives float32, with a Python number bf16. At float32
every layer is the plain ``torch.nn`` one.

``torch.autocast`` would keep LayerNorm and softmax in float32 and return
float32 from them, another policy than flax's, so the model casts
explicitly.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a norm takes its statistics in: at least float32 (flax's
    ``promote_types(dtype, float32)``)."""
    return torch.promote_types(x.dtype, torch.float32)


class Linear(nn.Linear):
    """``nn.Linear`` in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d),
                        None if self.bias is None else self.bias.to(d))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in ``dtype`` (flax ``Conv(dtype=...)``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        return self._conv_forward(
            x.to(d), self.weight.to(d),
            None if self.bias is None else self.bias.to(d))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in float32, returned in ``dtype`` (flax
    ``LayerNorm(dtype=...)``); the JAX package's epsilon is 1e-6."""

    def __init__(self, dims: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dims, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        d = stats_dtype(x)
        return F.layer_norm(x.to(d), self.normalized_shape,
                            self.weight.to(d), self.bias.to(d),
                            self.eps).to(self.dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (NCHW) in float32, returned in ``dtype`` (flax
    ``GroupNorm(dtype=...)``)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        d = stats_dtype(x)
        return F.group_norm(x.to(d), self.num_groups, self.weight.to(d),
                            self.bias.to(d), self.eps).to(self.dtype)
