"""Window attention over padded level rasters, forward and backward.

Contract (as ``pavenet_tpu/ops/pallas/window_attn.py::window_attention``):

- ``q``, ``k``, ``v``: ``(B, Hp, Wp, C)`` rasters, ``Hp % wh == 0``,
  ``Wp % ww == 0`` (padding and the shift roll are the caller's)
- ``keep``: ``(B, Hp, Wp)`` 0/1, 1 where the key is real content
- per non-overlapping ``(wh, ww)`` window and head (``D = C / num_heads``):
  scores ``q k^T / sqrt(D)`` in float32, ``-1e9`` at masked keys, softmax,
  the weights cast to the value's dtype, then ``A V``
- output: ``(B, Hp, Wp, C)`` in q's dtype; keep gets no gradient.

``window_attention_torch`` is the plain PyTorch version (its gradient is
autograd through it). The hand-written CUDA kernels are
``csrc/window_attn_fwd.cu`` and ``csrc/window_attn_bwd.cu``, joined by
``WindowAttnFunction``; ``window_attention`` dispatches by ``impl``.
"""
from __future__ import annotations

import torch

from . import _ext

NEG = -1e9
# the JAX package's names for the same two routes
IMPLS = {"torch": "torch", "xla": "torch", "cuda": "cuda", "pallas": "cuda"}


def _windows(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, Hp, Wp, ...) -> (B * nWh * nWw, wh * ww, ...)."""
    B, Hp, Wp = x.shape[:3]
    trail = x.shape[3:]
    x = x.reshape(B, Hp // wh, wh, Wp // ww, ww, *trail).transpose(2, 3)
    return x.reshape(-1, wh * ww, *trail)


def window_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           keep: torch.Tensor, num_heads: int, wh: int = 8,
                           ww: int = 16) -> torch.Tensor:
    """Plain version: partition into windows, f32 scores, masked softmax,
    weights in the value's dtype, ``A V`` summed in f32."""
    B, Hp, Wp, C = q.shape
    if Hp % wh or Wp % ww:
        raise ValueError(f"raster {Hp}x{Wp} is not a multiple of the "
                         f"({wh}, {ww}) window")
    D = C // num_heads

    def heads(x):                                  # (nW, heads, S, D)
        return _windows(x, wh, ww).unflatten(-1, (num_heads, D)).transpose(
            1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = (qh.float() @ kh.float().transpose(-1, -2)) * D ** -0.5
    kept = _windows(keep, wh, ww) > 0.5            # (nW, S)
    s = s.masked_fill(~kept[:, None, None, :], NEG)
    a = s.softmax(-1).to(v.dtype)
    out = (a.float() @ vh.float()).transpose(1, 2).flatten(2)   # (nW, S, C)
    out = out.view(B, Hp // wh, Wp // ww, wh, ww, C).transpose(2, 3)
    return out.reshape(B, Hp, Wp, C).to(q.dtype)


class WindowAttnFunction(torch.autograd.Function):
    """Window attention through the CUDA kernels: forward
    ``csrc/window_attn_fwd.cu``, backward ``csrc/window_attn_bwd.cu``. Saves
    q, k, v and keep; the backward kernel recomputes the softmax per window
    instead of keeping the scores."""

    @staticmethod
    def forward(ctx, q, k, v, keep, num_heads, wh, ww):
        ctx.save_for_backward(q, k, v, keep)
        ctx.window = (num_heads, wh, ww)
        out = _ext.window_attn_fwd(q, k, v, keep, num_heads, wh, ww)
        window_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, keep = ctx.saved_tensors
        dq, dk, dv = _ext.window_attn_bwd(
            q, k, v, keep, grad_out.to(q.dtype).contiguous(), *ctx.window)
        window_attention.backward_launches += 1
        return dq, dk, dv, None, None, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keep: torch.Tensor, num_heads: int, wh: int = 8,
                     ww: int = 16, impl: str = "auto") -> torch.Tensor:
    """Dispatch window attention; ``impl`` in {'auto', 'torch', 'cuda'} or
    the JAX package's names for them, 'xla' (plain) and 'pallas' (kernel).

    'auto' is 'cuda' for a CUDA ``q`` and 'torch' for a CPU one. 'cuda'
    runs ``WindowAttnFunction`` (the forward and backward kernels) or
    raises; it never falls back. ``window_attention.launches`` and
    ``window_attention.backward_launches`` count the kernel launches.
    """
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown window attention impl {impl!r}")
    if IMPLS[impl] == "torch":
        return window_attention_torch(q, k, v, keep, num_heads, wh, ww)
    if not q.is_cuda:
        raise ValueError(f"impl={impl!r} needs CUDA tensors; got {q.device}")
    return WindowAttnFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        keep.float().contiguous(), num_heads, wh, ww)


window_attention.launches = 0
window_attention.backward_launches = 0
