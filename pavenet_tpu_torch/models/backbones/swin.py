"""Swin Transformer backbone (as ``pavenet_tpu/models/backbones/swin.py``,
mmdet's ``SwinTransformer``; Swin-L-p4-w7 by default).

Input ``(N, 3, H, W)``, output a tuple of NCHW stage features, as the port's
ResNet; inside, the blocks work on NHWC maps. Each block pads its map to a
multiple of the window; every odd block of a stage rolls the padded map by
``-window // 2`` and masks attention across the rolled regions at -100
(the SW-MSA mask, built over the padded grid once per stage shape and
kept on the device by the backbone). There is no drop path, as in the JAX module. Window attention is
plain tensor code (matmul, relative position bias, softmax): the port's
window-attention kernel takes 128-token windows without a bias.

Every layer follows flax's ``dtype=`` policy (``models/layers/dtype.py``):
Dense layers in the activation dtype, LayerNorm statistics in float32, and
PyTorch's promotion where a float32 parameter meets a bf16 activation (the
bias table makes the attention logits float32 in a bf16 model, as in JAX).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers.dtype import Conv2d, LayerNorm, Linear

EPS = 1e-5
PATCH, MLP_RATIO = 4, 4          # Swin-L-p4-w7's patch size and MLP width


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C); H, W divisible by ws."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B*nH*nW, ws*ws, C) -> (B, H, W, C), the inverse of
    ``window_partition``."""
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the ``(2ws-1)**2`` bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shifted_window_mask(Hp: int, Wp: int, ws: int, shift: int
                        ) -> torch.Tensor:
    """The SW-MSA mask of one padded (Hp, Wp) map: (nW, L, L) float32,
    -100 between tokens of different rolled regions, else 0."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws)[..., 0]
    return torch.where(mw[:, None, :] != mw[:, :, None],
                       torch.tensor(-100.0), torch.tensor(0.0))


class WindowMSA(nn.Module):
    """Multi-head self-attention inside each window, with the learned
    relative position bias: fused ``qkv``, logits ``q k^T / sqrt(D)``,
    the bias table gathered to (H, L, L), the shifted mask per window
    group, softmax, ``proj``."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)
                             .astype(np.int64)), persistent=False)
        self.proj = Linear(dim, dim, dtype=dtype)
        # JAX divides by sqrt(D) rounded to the activation dtype
        self.scale = float(torch.tensor(
            math.sqrt(dim // num_heads), device="cpu").to(dtype))

    @torch.no_grad()
    def init_fixed_(self, generator):
        nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, 0.02,
                              -0.04, 0.04, generator=generator)

    def forward(self, x, mask=None):
        """x (nW, L, C); mask (nGroups, L, L) or None."""
        nW, L, C = x.shape
        H = self.num_heads
        q, k, v = (self.qkv(x).view(nW, L, 3, H, C // H)
                   .permute(2, 0, 3, 1, 4))                  # (nW, H, L, D)
        attn = (q @ k.transpose(-2, -1)) / self.scale
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(L, L, H)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            g = mask.shape[0]
            attn = (attn.view(nW // g, g, H, L, L)
                    + mask[None, :, None]).view(nW, H, L, L)
        attn = attn.softmax(-1)
        out = (attn @ v.to(attn.dtype)).transpose(1, 2).reshape(nW, L, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LayerNorm, (shifted) window attention on the padded map, crop,
    residual; LayerNorm, MLP with exact GELU, residual. NHWC."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim, eps=EPS, dtype=dtype)
        self.attn = WindowMSA(dim, num_heads, window_size, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=EPS, dtype=dtype)
        self.fc1 = Linear(dim, MLP_RATIO * dim, dtype=dtype)
        self.fc2 = Linear(MLP_RATIO * dim, dim, dtype=dtype)

    def forward(self, x, mask=None):
        """x (B, H, W, C); ``mask`` the SW-MSA mask of the padded map, used
        by a shifted block."""
        B, H, W, C = x.shape
        ws = self.window_size
        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        # mmdet shifts whenever configured, however small the map
        shift = ws // 2 if self.shift else 0
        if shift:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        x = window_reverse(self.attn(window_partition(x, ws),
                                     mask if shift else None), ws, Hp, Wp)
        if shift:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = shortcut + x[:, :H, :W]
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    """2x2 neighbourhoods concatenated in mmdet's order, LayerNorm, a
    reduction to ``out_dim`` without bias; odd sizes padded. NHWC."""

    def __init__(self, dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=EPS, dtype=dtype)
        self.reduction = Linear(4 * dim, out_dim, bias=False, dtype=dtype)

    def forward(self, x):
        _, H, W, _ = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Patch embedding (a 4x4 stride-4 conv on the input padded to a
    multiple of 4, then ``patch_norm``), four stages of Swin blocks with
    patch merging between them, and ``out_norm{i}`` on each output stage.
    ``out_channels`` are those of the output stages."""

    def __init__(self, embed_dims: int = 192,
                 depths: Tuple[int, ...] = (2, 2, 18, 2),
                 num_heads: Tuple[int, ...] = (6, 12, 24, 48),
                 window_size: int = 7,
                 out_indices: Tuple[int, ...] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        self.window_size, self.dtype = window_size, dtype
        self._masks = {}   # SW-MSA masks on the device, by padded shape
        self.patch_embed = Conv2d(3, embed_dims, PATCH, stride=PATCH,
                                  dtype=dtype)
        self.patch_norm = LayerNorm(embed_dims, eps=EPS, dtype=dtype)
        dim = embed_dims
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, num_heads[stage], window_size, shift=blk % 2 == 1,
                    dtype=dtype))
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}",
                                LayerNorm(dim, eps=EPS, dtype=dtype))
            if stage < len(self.depths) - 1:
                self.add_module(f"merge{stage}",
                                PatchMerging(dim, 2 * dim, dtype=dtype))
                dim *= 2
        self.out_channels = tuple(embed_dims * 2 ** s
                                  for s in self.out_indices)

    def forward(self, x, train: bool = False):
        """``train`` is taken as ResNet takes it, and ignored: Swin has no
        BatchNorm and, as the JAX module, no drop path."""
        _, _, H, W = x.shape
        x = F.pad(x, (0, (PATCH - W % PATCH) % PATCH,
                      0, (PATCH - H % PATCH) % PATCH))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))  # NHWC
        outs = []
        for stage, depth in enumerate(self.depths):
            mask = self._shift_mask(x.shape[1], x.shape[2], x.device)
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, mask)
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x)
                            .permute(0, 3, 1, 2))
            if stage < len(self.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return tuple(outs)

    def _shift_mask(self, H: int, W: int, device) -> torch.Tensor:
        """The SW-MSA mask of an (H, W) map padded to the window, in the
        activation dtype on ``device``, built once per shape."""
        ws = self.window_size
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        key = (Hp, Wp, str(device))
        if key not in self._masks:
            # a normal tensor even when first made under inference_mode,
            # so that a later train step may use it
            with torch.inference_mode(False):
                self._masks[key] = shifted_window_mask(
                    Hp, Wp, ws, ws // 2).to(device=device, dtype=self.dtype)
        return self._masks[key]
