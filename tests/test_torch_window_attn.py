"""The port's window attention (``pavenet_tpu_torch/ops/window_attn.py``)
against the JAX package's Pallas kernel, and the routing of the port's
``impl`` names for window attention and msda.

On the CPU the JAX side runs ``window_attention`` in interpret mode, forward
and its custom VJP (the Pallas backward kernel); the port runs
``window_attention_torch`` and autograd through it. The CUDA kernels have no
CPU mode: ``chip_smoke.py`` holds them against the plain version on the
card. Tolerances: 1e-5 forward and 1e-4 gradients (f32 sums in another
order). ``window_attention_levels`` (one call over a layer's level rasters)
is held level by level against the JAX kernel on rasters of mixed sizes,
and its level table (window offsets, total windows) against a count by
hand.
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
                                               window_attention_levels,
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
    counts = window_attention_levels
    before = (counts.launches, counts.backward_launches)
    out = window_attention(q, k, v, keep, 2, WH, WW, impl=impl)
    torch.testing.assert_close(
        out, window_attention_torch(q, k, v, keep, 2, WH, WW), rtol=0,
        atol=0)
    assert (counts.launches, counts.backward_launches) == before


@pytest.mark.parametrize("impl", ["cuda", "pallas"])
def test_window_kernel_names_raise_on_cpu(impl):
    q, k, v, keep, _ = (torch.from_numpy(x) for x in make_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        window_attention(q, k, v, keep, 2, WH, WW, impl=impl)
    with pytest.raises(ValueError, match="impl"):
        window_attention(q, k, v, keep, 2, WH, WW, impl="triton")


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, keep, g = ([torch.from_numpy(x)] for x in make_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        _ext.window_attn_fwd(q, k, v, keep, 2)
    with pytest.raises(ValueError, match="CUDA"):
        _ext.window_attn_bwd(q, k, v, keep, g, 2)


# ----------------------------------------------------------------------
# window_attention_levels: one call over a layer's level rasters
# ----------------------------------------------------------------------
# (Hp, Wp) of mixed levels: several windows, one window, one window row
LEVELS = ((16, 32), (8, 16), (8, 48))


def make_levels(seed=5, B=2, C=16):
    """Per level q, k, v, keep, g; level 0 has a fully masked window whose
    v is zeroed, as the encoder layer passes it."""
    rng = np.random.RandomState(seed)
    levels = []
    for Hp, Wp in LEVELS:
        q, k, v, g = (rng.randn(B, Hp, Wp, C).astype(np.float32)
                      for _ in range(4))
        keep = (rng.rand(B, Hp, Wp) > 0.3).astype(np.float32)
        levels.append([q, k, v, keep, g])
    levels[0][3][1, :WH, WW:] = 0.0
    levels[0][2] = levels[0][2] * levels[0][3][..., None]
    return levels


@pytest.mark.parametrize("heads", [1, 2])
def test_levels_plain_matches_pallas_interpret(heads):
    levels = make_levels()
    ins = [[torch.from_numpy(x).requires_grad_() for x in lv[:3]]
           for lv in levels]
    outs = window_attention_levels(
        *zip(*ins), [torch.from_numpy(lv[3]) for lv in levels], heads, WH,
        WW, impl="torch")
    assert len(outs) == len(LEVELS)
    sum((o * torch.from_numpy(lv[4])).sum()
        for o, lv in zip(outs, levels)).backward()
    for i, (lv, out, tin) in enumerate(zip(levels, outs, ins)):
        q, k, v, keep, g = lv
        want, vjp = jax.vjp(
            lambda a, b, c: j_window(a, b, c, jnp.asarray(keep), heads, WH,
                                     WW, True), q, k, v)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   atol=1e-5, err_msg=f"level {i}")
        for name, t, w in zip("qkv", tin, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       atol=1e-4,
                                       err_msg=f"level {i} d{name}")


@pytest.mark.parametrize("shapes, firsts, total", [
    ([(2, 16, 32)], [0], 8),
    ([(3, 104, 176), (3, 56, 96), (3, 32, 48), (3, 16, 32)],
     [0, 429, 555, 591], 603),
    ([(2, 16, 32), (2, 8, 16), (2, 8, 48)], [0, 8, 10], 16),
    ([(1, 8, 16), (4, 24, 16)], [0, 1], 13),
])
def test_level_table(shapes, firsts, total):
    table, windows = _ext.window_level_table(shapes, WH, WW)
    assert windows == total
    assert [row[3] for row in table] == firsts
    assert [row[:3] for row in table] == [tuple(s) for s in shapes]
    # every window once: the last window of each level ends where the next
    # level starts
    ends = [f + B * (Hp // WH) * (Wp // WW)
            for (B, Hp, Wp), f in zip(shapes, firsts)]
    assert ends == firsts[1:] + [total]


@pytest.mark.parametrize("shape", [(2, 12, 32), (2, 16, 20), (0, 8, 16)])
def test_level_table_refuses_partial_windows(shape):
    with pytest.raises(ValueError, match="window"):
        _ext.window_level_table([(1, 8, 16), shape], WH, WW)


@pytest.mark.parametrize("impl", ["auto", "torch", "xla"])
def test_levels_plain_names_loop_over_levels(impl):
    levels = [[torch.from_numpy(x) for x in lv] for lv in make_levels()]
    before = (window_attention_levels.launches,
              window_attention_levels.backward_launches)
    outs = window_attention_levels(*zip(*(lv[:4] for lv in levels)), 2, WH,
                                   WW, impl=impl)
    for out, (q, k, v, keep, _) in zip(outs, levels):
        torch.testing.assert_close(
            out, window_attention_torch(q, k, v, keep, 2, WH, WW), rtol=0,
            atol=0)
    assert (window_attention_levels.launches,
            window_attention_levels.backward_launches) == before


@pytest.mark.parametrize("impl", ["cuda", "pallas"])
def test_levels_kernel_names_raise_on_cpu(impl):
    levels = [[torch.from_numpy(x) for x in lv] for lv in make_levels()]
    with pytest.raises(ValueError, match="CUDA"):
        window_attention_levels(*zip(*(lv[:4] for lv in levels)), 2, WH, WW,
                                impl=impl)
    with pytest.raises(ValueError, match="impl"):
        window_attention_levels(*zip(*(lv[:4] for lv in levels)), 2, WH, WW,
                                impl="sdpa")


@pytest.mark.parametrize("case, match", [
    ("levels", "9 levels"), ("window", "128-token windows"),
    ("head_dim", "head size"), ("lists", "2 k for 1 levels")])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, match):
    q, k, v, keep, g = ([torch.from_numpy(x)] for x in make_inputs())
    heads, wh, ww = 2, WH, WW
    if case == "levels":
        q, k, v, keep = (x * 9 for x in (q, k, v, keep))
    elif case == "window":
        wh, ww = 8, 8
    elif case == "head_dim":
        heads = 4                       # D = 4
    else:
        k = k * 2
    with pytest.raises(ValueError, match=match):
        _ext.window_attn_fwd(q, k, v, keep, heads, wh, ww)


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
