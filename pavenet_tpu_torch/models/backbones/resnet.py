"""ResNet backbone (as ``pavenet_tpu/models/backbones/resnet.py``,
'pytorch' style: stride in the 3x3 conv), NCHW.

Norms by the JAX package's ``_make_norm``: ``FrozenBatchNorm`` (stored
statistics) where the norm is in eval mode for good, trainable
``BatchNorm`` elsewhere. With ``norm_eval=True`` every norm is frozen (every
pose production config); with ``norm_eval=False`` the stem stays frozen
while ``frozen_stages >= 0`` and the blocks of stage ``s`` (0-based) while
``s + 1 <= frozen_stages`` (the from-scratch recipes set -1: nothing
frozen). The ``train`` argument of ``forward`` puts the trainable norms in
train mode (batch statistics, running statistics updated); ``nn.Module``'s
own ``training`` flag does not. Frames are folded into the batch by the
caller.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers.dtype import Conv2d, stats_dtype

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics (buffers), as the JAX package's
    ``FrozenBatchNorm``: ``x * inv + b`` in ``dtype`` with ``inv`` and ``b``
    formed in float32. The affine ``weight`` and ``bias`` are parameters, as
    in the JAX package (``self.param``): they receive gradients, which count
    in the train step's clip norm, but the optimizer never updates them."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * inv
        return (x * inv.to(self.dtype)[:, None, None]
                + b.to(self.dtype)[:, None, None])


class BatchNorm(nn.Module):
    """Trainable BatchNorm with flax ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5, dtype=...)`` semantics, which differ from
    ``nn.BatchNorm2d``'s:

    - train mode: the batch statistics over (N, H, W) in float32, the
      variance as E[x^2] - E[x]^2 clipped at 0; the running statistics
      become ``0.9 * old + 0.1 * batch``, the *biased* batch variance
      included (torch keeps the unbiased one, with momentum 0.1);
    - eval mode: the running statistics;
    - ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32, cast
      to ``dtype``.

    No ``num_batches_tracked``: the JAX tree has none. Gradients flow
    through the batch statistics, as in flax.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        xf = x.to(stats_dtype(x))
        if train:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


def make_norm(features: int, norm_eval: bool,
              dtype: torch.dtype = torch.float32) -> nn.Module:
    """``FrozenBatchNorm`` (``norm_eval``) or trainable ``BatchNorm``; both
    keep ``weight``/``bias`` and ``running_mean``/``running_var``, so the
    JAX tree (``scale``/``bias``, ``batch_stats/{mean,var}``) loads into
    either."""
    return (FrozenBatchNorm(features, dtype=dtype) if norm_eval
            else BatchNorm(features, dtype=dtype))


def _conv(cin, cout, k, stride=1, padding=0, dtype=torch.float32):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False,
                  dtype=dtype)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm_eval: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = make_norm(planes, norm_eval, dtype)
        self.conv2 = _conv(planes, planes, 3, stride, 1, dtype=dtype)
        self.bn2 = make_norm(planes, norm_eval, dtype)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = make_norm(planes * 4, norm_eval, dtype)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride,
                                         dtype=dtype)
            self.downsample_bn = make_norm(planes * 4, norm_eval, dtype)
        self.downsample = downsample

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = (self.downsample_bn(self.downsample_conv(x), train)
                    if self.downsample else x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm_eval: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = make_norm(planes, norm_eval, dtype)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = make_norm(planes, norm_eval, dtype)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes, 1, stride,
                                         dtype=dtype)
            self.downsample_bn = make_norm(planes, norm_eval, dtype)
        self.downsample = downsample

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = (self.downsample_bn(self.downsample_conv(x), train)
                    if self.downsample else x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-{18,34,50,101,152}; ``out_indices`` pick stages 0..3 (C2..C5).
    Input ``(N, 3, H, W)``; returns a tuple of NCHW stage outputs in
    ``dtype``."""

    def __init__(self, depth: int = 50,
                 out_indices: Tuple[int, ...] = (1, 2, 3),
                 norm_eval: bool = True, frozen_stages: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block_name, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if block_name == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = make_norm(64, norm_eval or frozen_stages >= 0, dtype)
        self.stages = []
        inplanes, planes = 64, 64
        for stage, num_blocks in enumerate(stage_blocks):
            names = []
            for i in range(num_blocks):
                stride = (1 if stage == 0 else 2) if i == 0 else 1
                needs_ds = stride != 1 or inplanes != planes * block_cls.expansion
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(
                    inplanes, planes, stride, downsample=i == 0 and needs_ds,
                    norm_eval=norm_eval or stage + 1 <= frozen_stages,
                    dtype=dtype))
                names.append(name)
                inplanes = planes * block_cls.expansion
            self.stages.append(names)
            planes *= 2
        self.out_channels = tuple(64 * 2 ** s * block_cls.expansion
                                  for s in self.out_indices)

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, train)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
