"""RealNVP normalising flow of the RLE losses (as ``pavenet_tpu/models/
flows/realnvp.py``): six 2-d affine coupling layers with alternating masks,
scale nets ``2->64->64->2`` (LeakyReLU 0.01, Tanh output) and translation
nets without the Tanh; prior ``N((.5, .5), I)``.

Submodules are named ``s0..s5`` / ``t0..t5`` with ``Dense_0..Dense_2``, the
JAX parameter tree, so the weight converter maps them by name. In
``dtype`` as the JAX flow: the nets' Dense layers, the masks, the log-det
sum and the prior's ``log(2 pi)`` constant (rounded to ``dtype``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers.dtype import Linear


class _CouplingNet(nn.Module):

    def __init__(self, tanh_out: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tanh_out = tanh_out
        self.Dense_0 = Linear(2, 64, dtype=dtype)
        self.Dense_1 = Linear(64, 64, dtype=dtype)
        self.Dense_2 = Linear(64, 2, dtype=dtype)

    def init_fixed_(self, generator):
        for m in (self.Dense_0, self.Dense_1, self.Dense_2):
            nn.init.xavier_uniform_(m.weight, generator=generator)

    def forward(self, x):
        x = F.leaky_relu(self.Dense_0(x), 0.01)
        x = F.leaky_relu(self.Dense_1(x), 0.01)
        x = self.Dense_2(x)
        return torch.tanh(x) if self.tanh_out else x


class RealNVP(nn.Module):
    """``log_prob`` over 2-d residuals."""

    def __init__(self, num_coupling: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_coupling, self.dtype = num_coupling, dtype
        self.register_buffer("masks", torch.tensor(
            [[0.0, 1.0], [1.0, 0.0]] * (num_coupling // 2), dtype=dtype),
            persistent=False)
        # the JAX flow's jnp.asarray(log(2 pi), dtype)
        self.log_2pi = float(torch.tensor(math.log(2 * math.pi),
                                          dtype=dtype, device="cpu"))
        for i in range(num_coupling):
            self.add_module(f"s{i}", _CouplingNet(True, dtype))
            self.add_module(f"t{i}", _CouplingNet(False, dtype))

    def backward_p(self, x):
        """x (N, 2) -> (z (N, 2), log_det (N,))."""
        log_det = torch.zeros(x.shape[:-1], dtype=self.dtype,
                              device=x.device)
        z = x
        for i in reversed(range(self.num_coupling)):
            m = self.masks[i]
            z_ = m * z
            s = getattr(self, f"s{i}")(z_) * (1 - m)
            t = getattr(self, f"t{i}")(z_) * (1 - m)
            z = (1 - m) * (z - t) * torch.exp(-s) + z_
            log_det = log_det - s.sum(-1)
        return z, log_det

    def log_prob(self, x):
        """x (..., 2) -> log prob (...,)."""
        z, log_det = self.backward_p(x)
        d = z - 0.5
        return -0.5 * (d ** 2).sum(-1) - self.log_2pi + log_det
