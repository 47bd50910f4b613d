"""The port's msda (``pavenet_tpu_torch/ops/ms_deform_attn.py``) against the
JAX package's ``ms_deform_attn_xla`` on the same numpy inputs, forward and
gradients.

On the CPU the JAX side runs the XLA gather and its custom VJP, the plain
reference of the Pallas corner-stream kernels; the port runs
``ms_deform_attn_torch`` and autograd through it. The CUDA kernels have no
CPU mode: ``chip_smoke.py`` holds them against the plain version on the
card.
"""
import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.ops import ms_deform_attn_xla
from pavenet_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                  ms_deform_attn_torch)

# level sets with a 1-row and a 1-column level (the XLA path's H<2 / W<2
# branch) and a 1x1 level
LEVELS = {
    "L4": ((6, 9), (3, 5), (1, 3), (2, 1)),
    "L3": ((5, 7), (1, 1), (3, 2)),
}


def make_inputs(shapes, P, D, seed=0, B=2, Q=7, H=2):
    rng = np.random.RandomState(seed)
    n = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(B, n, H, D).astype(np.float32)
    locs = (rng.rand(B, Q, H, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    w = rng.rand(B, Q, H, L * P).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).reshape(B, Q, H, L, P)
    return value, locs, w


@pytest.mark.parametrize("D", [4, 32])
@pytest.mark.parametrize("P", [4, 15])
@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_plain_matches_jax(levels, P, D):
    shapes = LEVELS[levels]
    value, locs, w = make_inputs(shapes, P, D, seed=P + D)
    want = np.asarray(ms_deform_attn_xla(value, shapes, locs, w))
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(locs), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("D", [4, 32])
@pytest.mark.parametrize("P", [4, 15])
@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_plain_grads_match_jax(levels, P, D):
    """Gradients of value, locations and weights (1-row, 1-column and 1x1
    levels; locations up to 0.1 outside the map) at 1e-5."""
    shapes = LEVELS[levels]
    value, locs, w = make_inputs(shapes, P, D, seed=P + D + 1)
    g = np.random.RandomState(P * D).randn(
        *value.shape[:1], locs.shape[1], value.shape[2] * D).astype(
            np.float32)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_xla(v, shapes, l, a),
                     value, locs, w)
    want = [np.asarray(x) for x in vjp(g)]
    inputs = [torch.from_numpy(a).requires_grad_() for a in (value, locs, w)]
    out = ms_deform_attn(inputs[0], shapes, inputs[1], inputs[2])
    out.backward(torch.from_numpy(g))
    for name, x, ref in zip(("value", "loc", "attn"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), ref, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_far_out_of_range_is_zero():
    shapes = LEVELS["L4"]
    value, locs, w = make_inputs(shapes, 4, 4)
    got = ms_deform_attn_torch(torch.from_numpy(value), shapes,
                               torch.full(locs.shape, 5.0),
                               torch.from_numpy(w))
    assert torch.count_nonzero(got) == 0


def test_cuda_impl_raises_on_cpu_and_auto_launches_nothing():
    shapes = LEVELS["L3"]
    value, locs, w = (torch.from_numpy(a).requires_grad_()
                      for a in make_inputs(shapes, 4, 4))
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ms_deform_attn(value, shapes, locs, w, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ms_deform_attn(value, shapes, locs, w, impl="triton")
    out = ms_deform_attn(value, shapes, locs, w, impl="auto")
    assert out.shape == (2, 7, 2 * 4)
    out.sum().backward()
    assert value.grad is not None and locs.grad is not None
    assert (ms_deform_attn.launches,
            ms_deform_attn.backward_launches) == before


def test_shape_mismatch_raises():
    shapes = LEVELS["L3"]
    value, locs, w = (torch.from_numpy(a)
                      for a in make_inputs(shapes, 4, 4))
    with pytest.raises(ValueError, match="token count"):
        ms_deform_attn(value[:, 1:], shapes, locs, w)

