"""Sine positional encoding (as ``pavenet_tpu/models/layers/
positional_encoding.py``): cumulative sums over the valid region,
normalised to ``2*pi`` with ``offset=-0.5``; channels ``[y, x]`` with
interleaved sin/cos. ``SinePositionalEncoding`` is the config-built module
around the function."""
from __future__ import annotations

import math

import torch
import torch.nn as nn


def sine_positional_encoding(mask: torch.Tensor, num_feats: int = 128,
                             temperature: float = 10000.0,
                             normalize: bool = True, offset: float = -0.5,
                             scale: float = 2 * math.pi,
                             eps: float = 1e-6) -> torch.Tensor:
    """Args: mask ``(B, H, W)`` bool, True = padded. Returns ``(B,H,W,2F)``
    float32."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)


class SinePositionalEncoding(nn.Module):
    """``sine_positional_encoding`` with its options fixed at build (the
    reference registry's ``SinePositionalEncoding``); no parameters."""

    def __init__(self, num_feats=128, temperature=10000, normalize=True,
                 offset=-0.5, scale=2 * math.pi):
        super().__init__()
        self.num_feats = num_feats
        self.temperature = temperature
        self.normalize = normalize
        self.offset = offset
        self.scale = scale

    def forward(self, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return sine_positional_encoding(
            mask, self.num_feats, self.temperature, self.normalize,
            self.offset, self.scale).to(dtype)
