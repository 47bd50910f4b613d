"""Transformer bricks: Dropout, MLP, FFN, MultiheadAttention (as
``pavenet_tpu/models/layers/transformer.py``).

Residuals live inside FFN and MultiheadAttention (mmcv semantics); the
enclosing layer applies LayerNorm. Submodule names follow the JAX
parameter tree (``Dense_<i>``, ``MultiHeadDotProductAttention_0``), so the
weight converter is a plain tree walk. Dropout sits where the JAX package
puts it: in FFN after the hidden ReLU and after the output projection, in
MultiheadAttention after the output projection (none on the attention
probabilities). Dense layers compute in ``dtype`` (``layers/dtype.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dtype import Linear


class Dropout(nn.Module):
    """Inverted dropout in train mode whose masks come from ``generator``,
    a ``torch.Generator`` on the tensors' device that the trainer owns and
    sets (``nn.Dropout`` takes none); identity in eval mode or at p=0."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = torch.empty_like(x).bernoulli_(1 - self.p,
                                              generator=self.generator)
        return x * keep / (1 - self.p)


class MLP(nn.Module):
    """Hidden layers with ReLU, linear output."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 zero_init_last: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim, *hidden_dims, out_dim]
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            self.add_module(f"Dense_{i}", Linear(dims[i], dims[i + 1],
                                                 dtype=dtype))
        self.zero_init_last = zero_init_last

    def init_fixed_(self, generator):
        if self.zero_init_last:
            nn.init.zeros_(getattr(self, f"Dense_{self.num_layers - 1}")
                           .weight)

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x)


class FFN(nn.Module):
    """Two-layer feed-forward block with internal residual."""

    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 1024,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Linear(embed_dims, feedforward_channels, dtype=dtype)
        self.Dense_1 = Linear(feedforward_channels, embed_dims, dtype=dtype)
        self.drop_hidden = Dropout(dropout)
        self.drop_out = Dropout(dropout)

    def forward(self, x):
        hidden = self.drop_hidden(F.relu(self.Dense_0(x)))
        return x + self.drop_out(self.Dense_1(hidden))


class _DotProductAttention(nn.Module):
    """The JAX package's ``MultiHeadDotProductAttention`` written out:
    projections, scaled dot product, softmax, output projection, all in
    ``dtype`` (flax's softmax there runs in it too)."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.query = Linear(embed_dims, embed_dims, dtype=dtype)
        self.key = Linear(embed_dims, embed_dims, dtype=dtype)
        self.value = Linear(embed_dims, embed_dims, dtype=dtype)
        self.out = Linear(embed_dims, embed_dims, dtype=dtype)

    def forward(self, q, k, v):
        B, Lq, C = q.shape
        H = self.num_heads
        D = C // H
        q = self.query(q).view(B, Lq, H, D).transpose(1, 2) / D ** 0.5
        k = self.key(k).view(B, -1, H, D).transpose(1, 2)
        v = self.value(v).view(B, -1, H, D).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)   # (B,H,Lq,Lk)
        out = (attn @ v).transpose(1, 2).reshape(B, Lq, C)
        return self.out(out)


class MultiheadAttention(nn.Module):
    """Self-attention with ``query_pos`` added to query and key (DETR) and an
    internal residual. The value is the query without the position."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = _DotProductAttention(
            embed_dims, num_heads, dtype)
        self.drop = Dropout(dropout)

    def forward(self, query, query_pos=None):
        q = query if query_pos is None else query + query_pos
        return query + self.drop(self.MultiHeadDotProductAttention_0(
            q, q, query))
