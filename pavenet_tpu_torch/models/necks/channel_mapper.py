"""ChannelMapper neck (as ``pavenet_tpu/models/necks/channel_mapper.py``):
1x1 conv + GroupNorm(32) per input level, then extra 3x3/stride-2 conv + GN
levels from the last input until ``num_outs`` levels exist. No activation.
NCHW in and out, the convolutions in ``dtype`` and GroupNorm's statistics in
float32 (``models/layers/dtype.py``)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..layers.dtype import Conv2d, GroupNorm


class ChannelMapper(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_extra = num_outs - len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"conv{i}", Conv2d(cin, out_channels, 1,
                                               bias=False, dtype=dtype))
            self.add_module(f"gn{i}", GroupNorm(32, out_channels, eps=1e-5,
                                                dtype=dtype))
        cin = in_channels[-1]
        for j in range(self.num_extra):
            self.add_module(f"extra_conv{j}", Conv2d(
                cin, out_channels, 3, stride=2, padding=1, bias=False,
                dtype=dtype))
            self.add_module(f"extra_gn{j}", GroupNorm(
                32, out_channels, eps=1e-5, dtype=dtype))
            cin = out_channels

    def forward(self, inputs):
        outs = [getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
                for i, x in enumerate(inputs)]
        x = inputs[-1]
        for j in range(self.num_extra):
            x = getattr(self, f"extra_gn{j}")(getattr(self, f"extra_conv{j}")(x))
            outs.append(x)
        return tuple(outs)
