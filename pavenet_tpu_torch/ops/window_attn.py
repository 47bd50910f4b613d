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
``WindowAttnFunction``; each launch takes a list of level rasters (one
encoder layer's pyramid levels). ``window_attention_levels`` dispatches a
layer's levels by ``impl``; ``window_attention`` is its one-level case.
"""
from __future__ import annotations

import torch

from . import _ext, flops

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
    """Window attention over a list of level rasters through the CUDA
    kernels, one launch per direction: forward ``csrc/window_attn_fwd.cu``,
    backward ``csrc/window_attn_bwd.cu``. Called as ``apply(n, num_heads,
    wh, ww, *qs, *ks, *vs, *keeps)`` with ``n`` levels; returns the ``n``
    outputs. Saves q, k, v and keep; the backward kernel recomputes the
    softmax per window instead of keeping the scores."""

    @staticmethod
    def forward(ctx, n, num_heads, wh, ww, *tensors):
        qs, ks, vs, keeps = (tensors[i * n:(i + 1) * n] for i in range(4))
        ctx.save_for_backward(*tensors)
        ctx.window = (n, num_heads, wh, ww)
        outs = _ext.window_attn_fwd(qs, ks, vs, keeps, num_heads, wh, ww)
        window_attention_levels.launches += 1
        window_attention_levels.bf16_launches += (
            qs[0].dtype == torch.bfloat16)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n, num_heads, wh, ww = ctx.window
        tensors = ctx.saved_tensors
        qs, ks, vs, keeps = (tensors[i * n:(i + 1) * n] for i in range(4))
        gs = [g.to(q.dtype).contiguous() for g, q in zip(grads, qs)]
        dqs, dks, dvs = _ext.window_attn_bwd(qs, ks, vs, keeps, gs,
                                             num_heads, wh, ww)
        window_attention_levels.backward_launches += 1
        window_attention_levels.bf16_backward_launches += (
            qs[0].dtype == torch.bfloat16)
        return (None,) * 4 + (*dqs, *dks, *dvs) + (None,) * n


def window_attention_levels(qs, ks, vs, keeps, num_heads: int, wh: int = 8,
                            ww: int = 16, impl: str = "auto") -> list:
    """Window attention over the level rasters of one layer: per level
    ``(B, Hp, Wp, C)`` q, k, v and ``(B, Hp, Wp)`` keep, as
    :func:`window_attention_torch` takes them; returns the per-level
    outputs.

    ``impl`` in {'auto', 'torch', 'cuda'} or the JAX package's names for
    them, 'xla' (plain) and 'pallas' (kernel). 'auto' is 'cuda' for CUDA
    tensors and 'torch' for CPU ones. 'torch' loops over the levels with the
    plain version; 'cuda' runs ``WindowAttnFunction`` (one forward and one
    backward launch for all levels) or raises; it never falls back.
    ``window_attention_levels.launches`` and ``.backward_launches`` count
    the kernel launches, ``.bf16_launches`` and ``.bf16_backward_launches``
    those of them that took bfloat16 rasters. Inside
    ``flops.kernel_flops()`` every call adds its operations to the tally.
    """
    if not len(qs) == len(ks) == len(vs) == len(keeps) > 0:
        raise ValueError(f"level lists of lengths {len(qs)}, {len(ks)}, "
                         f"{len(vs)}, {len(keeps)}")
    if impl == "auto":
        impl = "cuda" if qs[0].is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown window attention impl {impl!r}")
    flops.record_window(qs, (wh, ww))
    if IMPLS[impl] == "torch":
        with flops.outside_counter():
            return [window_attention_torch(q, k, v, keep, num_heads, wh, ww)
                    for q, k, v, keep in zip(qs, ks, vs, keeps)]
    if not all(t.is_cuda for t in (*qs, *ks, *vs, *keeps)):
        raise ValueError(f"impl={impl!r} needs CUDA tensors; got "
                         f"{qs[0].device}")
    return list(WindowAttnFunction.apply(
        len(qs), num_heads, wh, ww, *(x.contiguous() for x in qs),
        *(x.contiguous() for x in ks), *(x.contiguous() for x in vs),
        *(x.float().contiguous() for x in keeps)))


window_attention_levels.launches = 0
window_attention_levels.backward_launches = 0
window_attention_levels.bf16_launches = 0
window_attention_levels.bf16_backward_launches = 0


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keep: torch.Tensor, num_heads: int, wh: int = 8,
                     ww: int = 16, impl: str = "auto") -> torch.Tensor:
    """One raster: :func:`window_attention_levels` on a single level (the
    JAX package's ``window_attention`` call)."""
    return window_attention_levels([q], [k], [v], [keep], num_heads, wh, ww,
                                   impl)[0]
