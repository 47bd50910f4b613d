"""ResNet backbone with frozen BatchNorm (as ``pavenet_tpu/models/backbones/
resnet.py``, 'pytorch' style: stride in the 3x3 conv), NCHW.

Only the frozen-statistics norm is here (every pose config sets
``norm_eval=True``); trainable BatchNorm waits for a later slice. Frames are
folded into the batch by the caller.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics (buffers). The affine ``weight`` and
    ``bias`` are parameters, as in the JAX package (``self.param``): they
    receive gradients, which count in the train step's clip norm, but the
    optimizer never updates them."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + b[:, None, None]


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(planes)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-{18,34,50,101,152}; ``out_indices`` pick stages 0..3 (C2..C5).
    Input ``(N, 3, H, W)``; returns a tuple of NCHW stage outputs."""

    def __init__(self, depth: int = 50, out_indices: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        block_name, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if block_name == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        self.stages = []
        inplanes, planes = 64, 64
        for stage, num_blocks in enumerate(stage_blocks):
            names = []
            for i in range(num_blocks):
                stride = (1 if stage == 0 else 2) if i == 0 else 1
                needs_ds = stride != 1 or inplanes != planes * block_cls.expansion
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(inplanes, planes, stride,
                                                downsample=i == 0 and needs_ds))
                names.append(name)
                inplanes = planes * block_cls.expansion
            self.stages.append(names)
            planes *= 2
        self.out_channels = tuple(64 * 2 ** s * block_cls.expansion
                                  for s in self.out_indices)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
