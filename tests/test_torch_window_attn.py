"""The port's window attention (``pavenet_tpu_torch/ops/window_attn.py``)
against the JAX package's Pallas kernel, and the routing of the port's
``impl`` names for window attention and msda.

On the CPU the JAX side runs ``window_attention`` in interpret mode, forward
and its custom VJP (the Pallas backward kernel); the port runs
``window_attention_torch`` and autograd through it. The CUDA kernels have no
CPU mode: ``chip_smoke.py`` holds them against the plain version on the
card. Tolerances: 1e-5 forward and 1e-4 gradients (f32 sums in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.ops.pallas.window_attn import window_attention as j_window
from pavenet_tpu_torch.ops import _ext
from pavenet_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                  ms_deform_attn_torch)
from pavenet_tpu_torch.ops.window_attn import (window_attention,
                                               window_attention_torch)

WH, WW = 8, 16


def make_inputs(case="random_keep", seed=3, B=2, Hp=16, Wp=32, C=16):
    """The JAX kernel test's shapes (``tests/test_window_attn.py``). Case
    'random_keep' masks keys at random; 'masked_window' also masks one
    whole window and zeroes v at every masked key, as the encoder layer
    does."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, Hp, Wp, C).astype(np.float32) for _ in range(3))
    keep = (rng.rand(B, Hp, Wp) > 0.3).astype(np.float32)
    if case == "masked_window":
        keep[1, WH:, :WW] = 0.0
        v = v * keep[..., None]
    g = rng.randn(B, Hp, Wp, C).astype(np.float32)
    return q, k, v, keep, g


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("case", ["random_keep", "masked_window"])
def test_plain_matches_pallas_interpret(case, heads):
    q, k, v, keep, g = make_inputs(case)
    want, vjp = jax.vjp(
        lambda a, b, c: j_window(a, b, c, jnp.asarray(keep), heads, WH, WW,
                                 True), q, k, v)
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = window_attention_torch(tq, tk, tv, torch.from_numpy(keep), heads,
                                 WH, WW)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=f"d{name}")


def test_fully_masked_window_is_the_mean_of_values():
    q, k, v, keep, _ = make_inputs()
    keep[0, :WH, WW:] = 0.0
    got = window_attention_torch(*map(torch.from_numpy, (q, k, v, keep)), 2,
                                 WH, WW).numpy()
    want = v[0, :WH, WW:].reshape(-1, v.shape[-1]).mean(0)
    np.testing.assert_allclose(got[0, :WH, WW:],
                               np.broadcast_to(want, (WH, WW, len(want))),
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "torch", "xla"])
def test_window_plain_names_route_to_plain(impl):
    q, k, v, keep, _ = (torch.from_numpy(x) for x in make_inputs())
    before = (window_attention.launches, window_attention.backward_launches)
    out = window_attention(q, k, v, keep, 2, WH, WW, impl=impl)
    torch.testing.assert_close(
        out, window_attention_torch(q, k, v, keep, 2, WH, WW), rtol=0,
        atol=0)
    assert (window_attention.launches,
            window_attention.backward_launches) == before


@pytest.mark.parametrize("impl", ["cuda", "pallas"])
def test_window_kernel_names_raise_on_cpu(impl):
    q, k, v, keep, _ = (torch.from_numpy(x) for x in make_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        window_attention(q, k, v, keep, 2, WH, WW, impl=impl)
    with pytest.raises(ValueError, match="impl"):
        window_attention(q, k, v, keep, 2, WH, WW, impl="triton")


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, keep, g = (torch.from_numpy(x) for x in make_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        _ext.window_attn_fwd(q, k, v, keep, 2)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.window_attn_bwd(q, k, v, keep, g, 2)


def _msda_inputs(seed=0, B=2, Q=7, H=2, P=4, D=4):
    shapes = ((5, 7), (1, 1), (3, 2))
    rng = np.random.RandomState(seed)
    n, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(B, n, H, D).astype(np.float32)
    locs = (rng.rand(B, Q, H, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    w = rng.rand(B, Q, H, L, P).astype(np.float32)
    return shapes, *map(torch.from_numpy, (value, locs, w / w.sum()))


@pytest.mark.parametrize("impl", ["auto", "torch", "xla"])
def test_msda_plain_names_route_to_plain(impl):
    shapes, value, locs, w = _msda_inputs()
    before = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    out = ms_deform_attn(value, shapes, locs, w, impl=impl)
    torch.testing.assert_close(out, ms_deform_attn_torch(value, shapes, locs,
                                                         w), rtol=0, atol=0)
    assert (ms_deform_attn.launches,
            ms_deform_attn.backward_launches) == before


@pytest.mark.parametrize("impl", ["cuda", "pallas", "cs", "pallas_split"])
def test_msda_kernel_names_raise_on_cpu(impl):
    shapes, value, locs, w = _msda_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        ms_deform_attn(value, shapes, locs, w, impl=impl)
