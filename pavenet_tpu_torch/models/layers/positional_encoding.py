"""Sine positional encoding (as ``pavenet_tpu/models/layers/
positional_encoding.py``): cumulative sums over the valid region,
normalised to ``2*pi`` with ``offset=-0.5``; channels ``[y, x]`` with
interleaved sin/cos."""
from __future__ import annotations

import math

import torch


def sine_positional_encoding(mask: torch.Tensor,
                             num_feats: int = 128) -> torch.Tensor:
    """Args: mask ``(B, H, W)`` bool, True = padded. Returns ``(B,H,W,2F)``
    float32 (temperature 1e4, offset -0.5, scale 2*pi, eps 1e-6)."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + 1e-6) * (2 * math.pi)
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)
