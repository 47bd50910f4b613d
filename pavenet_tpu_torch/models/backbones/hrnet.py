"""HRNet backbone (as ``pavenet_tpu/models/backbones/hrnet.py``), NCHW:
a stem of two stride-2 3x3 convs, a Bottleneck stage 1, then stages of
multi-resolution modules, BasicBlock branches with full cross-resolution
fusion after every module:

- low to high resolution: a 1x1 conv and BatchNorm, a nearest upsample by
  2^(j-i), then a crop to the target's shape;
- high to low: a chain of stride-2 3x3 convs with BatchNorm, ReLU between
  them and none after the last;
- a ReLU after each sum.

A transition adds a conv only where a branch's width changes, and a
stride-2 conv from the previous lowest branch for each new one. Returns
all four branch maps (strides 4, 8, 16, 32); the detector keeps
``backbone_out_indices`` of them. Every BatchNorm has frozen statistics
(the JAX module's ``FrozenBatchNorm``), whatever the config's
``norm_eval``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers.dtype import Conv2d
from .resnet import BasicBlock, Bottleneck, FrozenBatchNorm

# (block, num_modules, num_blocks, channels) per stage: W48 as the PETR
# config, W32 as mmpose's common variant
HRNET_EXTRA = {
    48: (
        ("bottleneck", 1, (4,), (64,)),
        ("basic", 1, (4, 4), (48, 96)),
        ("basic", 4, (4, 4, 4), (48, 96, 192)),
        ("basic", 3, (4, 4, 4, 4), (48, 96, 192, 384)),
    ),
    32: (
        ("bottleneck", 1, (4,), (64,)),
        ("basic", 1, (4, 4), (32, 64)),
        ("basic", 4, (4, 4, 4), (32, 64, 128)),
        ("basic", 3, (4, 4, 4, 4), (32, 64, 128, 256)),
    ),
}


class ConvBN(nn.Module):
    """Conv (no bias, 'same' padding), frozen BatchNorm, optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride,
                           padding=kernel // 2, bias=False, dtype=dtype)
        self.bn = FrozenBatchNorm(cout, dtype=dtype)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class HRModule(nn.Module):
    """Parallel BasicBlock stacks, one per branch, and full fusion."""

    def __init__(self, channels: Sequence[int], num_blocks: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.num_blocks = tuple(channels), tuple(num_blocks)
        n = len(channels)
        for b, c in enumerate(channels):
            for k in range(num_blocks[b]):
                self.add_module(f"branch{b}_block{k}",
                                BasicBlock(c, c, dtype=dtype))
        for i in range(n if n > 1 else 0):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse{i}_{j}_conv", Conv2d(
                        channels[j], channels[i], 1, bias=False,
                        dtype=dtype))
                    self.add_module(f"fuse{i}_{j}_bn", FrozenBatchNorm(
                        channels[i], dtype=dtype))
                for t in range(i - j):
                    last = t == i - j - 1
                    self.add_module(f"fuse{i}_{j}_down{t}", ConvBN(
                        channels[j], channels[i] if last else channels[j],
                        3, 2, relu=not last, dtype=dtype))

    def forward(self, xs):
        n = len(self.channels)
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks[b]):
                x = getattr(self, f"branch{b}_block{k}")(x)
            ys.append(x)
        if n == 1:
            return ys
        outs = []
        for i in range(n):
            acc = None
            for j in range(n):
                y = ys[j]
                if j > i:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(y))
                    s = 2 ** (j - i)
                    y = y.repeat_interleave(s, 2).repeat_interleave(s, 3)
                    y = y[:, :, :ys[i].shape[2], :ys[i].shape[3]]
                for t in range(i - j):
                    y = getattr(self, f"fuse{i}_{j}_down{t}")(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """HRNet-W48 (PETR) or W32. Input ``(N, 3, H, W)``; returns the four
    branch maps in ``dtype``; ``out_channels`` are their widths."""

    def __init__(self, width: int = 48, dtype: torch.dtype = torch.float32):
        super().__init__()
        extra = HRNET_EXTRA[width]
        self.stem1 = ConvBN(3, 64, 3, 2, dtype=dtype)
        self.stem2 = ConvBN(64, 64, 3, 2, dtype=dtype)
        _, _, (n1,), (c1,) = extra[0]
        inplanes = 64
        for k in range(n1):
            self.add_module(f"layer1_{k}", Bottleneck(
                inplanes, c1, downsample=k == 0, dtype=dtype))
            inplanes = c1 * Bottleneck.expansion
        self.num_layer1 = n1
        self.stages = []
        prev = (inplanes,)
        for s, (_, num_modules, num_blocks, channels) in enumerate(
                extra[1:], start=2):
            for b, c in enumerate(channels):
                if b >= len(prev):      # the new lowest-resolution branch
                    self.add_module(f"transition{s - 1}_{b}", ConvBN(
                        prev[-1], c, 3, 2, dtype=dtype))
                elif prev[b] != c:
                    self.add_module(f"transition{s - 1}_{b}", ConvBN(
                        prev[b], c, 3, 1, dtype=dtype))
            for m in range(num_modules):
                self.add_module(f"stage{s}_module{m}", HRModule(
                    channels, num_blocks, dtype=dtype))
            self.stages.append((s, len(channels), num_modules))
            prev = tuple(channels)
        self.out_channels = prev

    def forward(self, x, train: bool = False):
        x = self.stem2(self.stem1(x))
        for k in range(self.num_layer1):
            x = getattr(self, f"layer1_{k}")(x)
        xs = [x]
        for s, n, num_modules in self.stages:
            new = []
            for b in range(n):
                name = f"transition{s - 1}_{b}"
                src = xs[b] if b < len(xs) else xs[-1]
                new.append(getattr(self, name)(src) if hasattr(self, name)
                           else src)
            xs = new
            for m in range(num_modules):
                xs = getattr(self, f"stage{s}_module{m}")(xs)
        return tuple(xs)
