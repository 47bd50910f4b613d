"""Multi-scale deformable attention (msda), forward and backward.

Contract (as ``pavenet_tpu/ops/ms_deform_attn.py``):

- ``value``: ``(B, N, H, D)``, ``N = sum_l H_l * W_l``
- ``spatial_shapes``: static ``((H_0, W_0), ...)`` python ints
- ``sampling_locations``: ``(B, Q, H, L, P, 2)``, xy in ``[0, 1]`` per level
- ``attention_weights``: ``(B, Q, H, L, P)``, already softmaxed by the caller
- pixel centres at ``loc * (W, H) - 0.5``; out-of-range corners count zero
- output: ``(B, Q, H * D)``

``ms_deform_attn_torch`` is the plain PyTorch version (``F.grid_sample``;
its gradient is autograd through it). The hand-written CUDA kernels are
``csrc/msda_fwd.cu`` and ``csrc/msda_bwd.cu``, joined by
``MSDeformAttnFunction``; ``ms_deform_attn`` dispatches by the device of
``value``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _ext, flops

Shapes = Tuple[Tuple[int, int], ...]
# the JAX package's names for the same two routes: its XLA gather, and its
# Pallas kernels (first-generation 'pallas' and 'pallas_split', corner-stream
# 'cs'), which all compute the function the CUDA kernels compute
IMPLS = {"torch": "torch", "xla": "torch", "cuda": "cuda", "pallas": "cuda",
         "cs": "cuda", "pallas_split": "cuda"}


def _check_shapes(value, spatial_shapes: Sequence, locations) -> Shapes:
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if sum(h * w for h, w in shapes) != value.shape[1]:
        raise ValueError(f"token count mismatch: {shapes} vs {value.shape[1]}")
    if locations.shape[3] != len(shapes):
        raise ValueError(f"level mismatch: {tuple(locations.shape)} vs "
                         f"{len(shapes)} levels")
    return shapes


def ms_deform_attn_torch(value: torch.Tensor, spatial_shapes: Sequence,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version: one bilinear, zero-padded ``grid_sample`` per level,
    computed in float32 (as the kernel accumulates) and returned in the
    value's dtype."""
    shapes = _check_shapes(value, spatial_shapes, sampling_locations)
    B, _, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    values = value.float().split([h * w for h, w in shapes], dim=1)
    grids = 2 * sampling_locations.float() - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * H, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (BH,Q,P,2)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))     # (BH,D,Q,P)
    a = attention_weights.float().transpose(1, 2).reshape(B * H, 1, Q, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)  # (BH,D,Q)
    return out.view(B, H * D, Q).transpose(1, 2).to(value.dtype).contiguous()


class MSDeformAttnFunction(torch.autograd.Function):
    """msda through the CUDA kernels: forward ``csrc/msda_fwd.cu``, backward
    ``csrc/msda_bwd.cu``. Saves only value, locations and weights (the
    level shapes ride in ``ctx``); the backward kernel recomputes the
    bilinear taps (as the JAX path rematerialises them) instead of keeping
    them alive."""

    @staticmethod
    def forward(ctx, value, shapes, locations, weights):
        ctx.shapes = shapes
        ctx.save_for_backward(value, locations, weights)
        out = _ext.msda_fwd(value, shapes, locations, weights)
        ms_deform_attn.launches += 1
        ms_deform_attn.bf16_launches += value.dtype == torch.bfloat16
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, locations, weights = ctx.saved_tensors
        grads = _ext.msda_bwd(value, ctx.shapes, locations, weights,
                              _aligned(grad_out.float()))
        ms_deform_attn.backward_launches += 1
        ms_deform_attn.bf16_backward_launches += value.dtype == torch.bfloat16
        grad_value, grad_loc, grad_attn = grads
        return grad_value, None, grad_loc, grad_attn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels read it (a copy
    only where a view starts off a 16-byte boundary)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """Dispatch msda; ``impl`` in {'auto', 'torch', 'cuda'} or the JAX
    package's names for them: 'xla' (plain), 'pallas', 'cs' and
    'pallas_split' (kernels).

    'auto' is 'cuda' for a CUDA ``value`` and 'torch' for a CPU one. 'cuda'
    runs ``MSDeformAttnFunction`` (the forward and backward kernels) or
    raises; it never falls back. ``ms_deform_attn.launches`` and
    ``ms_deform_attn.backward_launches`` count the kernel launches,
    ``.bf16_launches`` and ``.bf16_backward_launches`` those of them that
    took a bfloat16 value. Inside ``flops.kernel_flops()`` every call adds
    its operations to the tally.
    """
    if impl == "auto":
        impl = "cuda" if value.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown msda impl {impl!r}")
    flops.record_msda(value, sampling_locations)
    if IMPLS[impl] == "torch":
        with flops.outside_counter():
            return ms_deform_attn_torch(value, spatial_shapes,
                                        sampling_locations, attention_weights)
    if not value.is_cuda:
        raise ValueError(f"impl={impl!r} needs CUDA tensors; got "
                         f"{value.device}")
    shapes = _check_shapes(value, spatial_shapes, sampling_locations)
    return MSDeformAttnFunction.apply(
        _aligned(value), shapes, _aligned(sampling_locations.float()),
        _aligned(attention_weights.float()))


ms_deform_attn.launches = 0
ms_deform_attn.backward_launches = 0
ms_deform_attn.bf16_launches = 0
ms_deform_attn.bf16_backward_launches = 0
