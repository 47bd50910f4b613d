"""ChannelMapper neck (as ``pavenet_tpu/models/necks/channel_mapper.py``):
1x1 conv + GroupNorm(32) per input level, then extra 3x3/stride-2 conv + GN
levels from the last input until ``num_outs`` levels exist. No activation.
NCHW in and out."""
from __future__ import annotations

from typing import Sequence

import torch.nn as nn


class ChannelMapper(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4):
        super().__init__()
        self.num_extra = num_outs - len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"conv{i}", nn.Conv2d(cin, out_channels, 1,
                                                  bias=False))
            self.add_module(f"gn{i}", nn.GroupNorm(32, out_channels,
                                                   eps=1e-5))
        cin = in_channels[-1]
        for j in range(self.num_extra):
            self.add_module(f"extra_conv{j}", nn.Conv2d(
                cin, out_channels, 3, stride=2, padding=1, bias=False))
            self.add_module(f"extra_gn{j}", nn.GroupNorm(
                32, out_channels, eps=1e-5))
            cin = out_channels

    def forward(self, inputs):
        outs = [getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
                for i, x in enumerate(inputs)]
        x = inputs[-1]
        for j in range(self.num_extra):
            x = getattr(self, f"extra_gn{j}")(getattr(self, f"extra_conv{j}")(x))
            outs.append(x)
        return tuple(outs)
