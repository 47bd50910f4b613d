"""FPN neck (as ``pavenet_tpu/models/necks/fpn.py``): mmdet's ``FPN`` as
InsPose configures it (``start_level=1``, ``num_outs=5``,
``add_extra_convs='on_output'``, ``relu_before_extra_convs=True``).

1x1 lateral convolutions with bias on the backbone levels from
``start_level``, nearest x2 top-down sums (the upsampled level cropped to
the finer one's shape: odd sizes round up under x2), a 3x3 output
convolution per level, then stride-2 3x3 convolutions stacked on the last
output, with a ReLU before all but the first. NCHW in and out; the
convolutions in ``dtype``. Module names follow the JAX tree
(``lateral{i}``, ``fpn{i}``, ``fpn_extra{j}``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers.dtype import Conv2d


def upsample2x_nearest(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest x2 of ``x`` (N, C, h, w), cropped to ``like``'s spatial
    shape."""
    y = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return y[..., : like.shape[-2], : like.shape[-1]]


class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5,
                 relu_before_extra_convs: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.start_level = start_level
        self.relu_before_extra_convs = relu_before_extra_convs
        used = list(in_channels[start_level:])
        self.num_levels = len(used)
        self.num_extra = num_outs - len(used)
        for i, cin in enumerate(used):
            self.add_module(f"lateral{i}", Conv2d(cin, out_channels, 1,
                                                  dtype=dtype))
            self.add_module(f"fpn{i}", Conv2d(out_channels, out_channels, 3,
                                              padding=1, dtype=dtype))
        for j in range(self.num_extra):
            self.add_module(f"fpn_extra{j}", Conv2d(
                out_channels, out_channels, 3, stride=2, padding=1,
                dtype=dtype))

    def forward(self, inputs):
        used = list(inputs[self.start_level:])
        laterals = [getattr(self, f"lateral{i}")(x)
                    for i, x in enumerate(used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample2x_nearest(
                laterals[i], laterals[i - 1])
        outs = [getattr(self, f"fpn{i}")(lat)
                for i, lat in enumerate(laterals)]
        for j in range(self.num_extra):
            x = outs[-1]
            if j > 0 and self.relu_before_extra_convs:
                x = F.relu(x)
            outs.append(getattr(self, f"fpn_extra{j}")(x))
        return tuple(outs)
