"""The head sizes the kernels take: msda at every power of two from 2 to
256 (SOIT's seg encoder runs one 256-channel head, its dynamic mask call
4 heads of 2 channels), window attention at
8, 16, 32 and 64 in both directions and dtypes, on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions there, phases 4, 5 and 7). Here: msda's plain version at
H=1, D=256 against the JAX package's ``ms_deform_attn`` (the XLA gather,
forward 1e-5, gradients 1e-4; bf16 values at 2e-2 of the largest output,
where the XLA path forms its weights and sums in bf16 and the port sums in
f32), the plan at the new head sizes, the numpy emulation of the kernels'
partition at D=64 against the plain version (the backward's 32-channel
passes add per channel, so the emulation of one pass is the whole), the
window plain version at head sizes 16 and 64 against the Pallas kernel in
interpret mode, and the wrappers' refusals, which name the sizes taken.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.ops.ms_deform_attn import ms_deform_attn as j_msda
from pavenet_tpu.ops.pallas.window_attn import window_attention as j_window
from pavenet_tpu_torch.ops import _ext
from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
from pavenet_tpu_torch.ops.window_attn import window_attention_torch
from test_torch_msda_plan import FLAGSHIP, SMALL, emulate, partition_plans

LEVELS = ((6, 9), (3, 5), (1, 3), (2, 1))
t = torch.from_numpy


def msda_inputs(shapes, Q, H, P, D, seed):
    rng = np.random.RandomState(seed)
    n, L = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(2, n, H, D).astype(np.float32)
    loc = (rng.rand(2, Q, H, L, P, 2) * 1.2 - 0.1).astype(np.float32)
    w = rng.rand(2, Q, H, L * P).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).reshape(2, Q, H, L, P)
    g = rng.randn(2, Q, H * D).astype(np.float32)
    return value, loc, w, g


def test_msda_plain_at_one_256_channel_head_matches_jax():
    value, loc, w, g = msda_inputs(LEVELS, 9, 1, 4, 256, seed=4)

    @jax.jit
    def forward_and_grads(v, l, a, g):
        out, vjp = jax.vjp(lambda *x: j_msda(x[0], LEVELS, *x[1:],
                                             impl="xla"), v, l, a)
        return out, vjp(g)

    want, want_grads = forward_and_grads(value, loc, w, g)
    ins = [t(x).requires_grad_() for x in (value, loc, w)]
    got = ms_deform_attn_torch(ins[0], LEVELS, *ins[1:])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got.backward(t(g))
    for name, x, want_g in zip(("value", "loc", "attn"), ins, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_msda_plain_at_one_256_channel_head_bf16():
    value, loc, w, _ = msda_inputs(LEVELS, 9, 1, 4, 256, seed=5)
    vb = jnp.asarray(value, jnp.bfloat16)
    want = np.asarray(j_msda(vb, LEVELS, loc, w, impl="xla"), np.float32)
    got = ms_deform_attn_torch(t(value).bfloat16(), LEVELS, t(loc), t(w))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("D, fwd_lanes, bwd_lanes", [
    (16, 2, 4), (64, 8, 8), (128, 16, 8), (256, 32, 8), (2, 1, 1)])
def test_plan_takes_the_new_head_sizes(D, fwd_lanes, bwd_lanes):
    """The flagship levels at H=1: a forward item takes D/8 lanes (up to a
    warp; one at D=2), a backward item 8 lanes at most (32 channels a
    pass; one at D=2); at D=2 the forward stages nothing and the backward
    every level that fits; else forward,
    f32 rows of D*4 bytes stage only what fits (at D=256 no level: the
    coarsest has 273 rows of 1 KB); backward, a block's 64 queries have
    fewer taps (256) than any level has rows."""
    for backward, lanes in ((False, fwd_lanes), (True, bwd_lanes)):
        plan = _ext.msda_plan(FLAGSHIP, 3, 22323, 1, 4, D, torch.float32,
                              backward)
        blocks = min(4, _ext.MSDA_SM_SMEM_BYTES // (plan.smem + 1152))
        assert plan.threads == min(1024 // blocks // 32 * 32,
                                   -(-plan.chunk * lanes // 32) * 32)
        rows = sum(h * w for h, w, r in plan.levels if r >= 0)
        assert plan.smem == rows * D * 4 <= _ext.MSDA_SMEM_BYTES
        if D == 2:     # every level backward (178,584 B), none forward
            assert rows == (22323 if backward else 0)
        else:
            assert (rows == 0) == (backward or D == 256)
    # three blocks an SM (their tables of 69,888 B): 320 threads each, a
    # whole number of warps
    plan = _ext.msda_plan(FLAGSHIP, 3, 2000, 8, 4, 64, torch.float32)
    assert (plan.smem, plan.threads) == (273 * 256, 320)


def test_plan_refusal_names_the_head_sizes():
    with pytest.raises(ValueError,
                       match=r"\(2, 4, 8, 16, 32, 64, 128, 256\)"):
        _ext.msda_plan(SMALL, 1, 4, 1, 4, 48, torch.float32)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("plan_name", ["planned", "all_staged", "direct"])
def test_partition_at_64_channels_matches_plain(plan_name, backward):
    value, loc, w, g = msda_inputs(SMALL, 7, 2, 4, 64, seed=6)
    plan = partition_plans(SMALL, 2, 7, 2, 4, 64, backward)[plan_name]
    if not backward:
        got = emulate(value, SMALL, loc, w, plan)
        want = ms_deform_attn_torch(t(value), SMALL, t(loc), t(w))
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
        return
    got = emulate(value, SMALL, loc, w, plan, g.reshape(2, 7, 2, 64))
    ins = [t(x).requires_grad_() for x in (value, loc, w)]
    ms_deform_attn_torch(ins[0], SMALL, *ins[1:]).backward(t(g))
    for name, a, x in zip(("value", "loc", "attn"), got, ins):
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("C, heads", [(32, 2), (128, 2)])
def test_window_plain_at_head_sizes_16_and_64_matches_pallas(C, heads):
    rng = np.random.RandomState(C)
    q, k, v, g = (rng.randn(2, 8, 32, C).astype(np.float32)
                  for _ in range(4))
    keep = (rng.rand(2, 8, 32) > 0.3).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: j_window(
        a, b, c, jnp.asarray(keep), heads, 8, 16, True), q, k, v)
    want_grads = vjp(jnp.asarray(g))
    ins = [t(x).requires_grad_() for x in (q, k, v)]
    got = window_attention_torch(*ins, t(keep), heads)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    got.backward(t(g))
    for name, x, want_g in zip("qkv", ins, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("D, dtype, backward, taken", [
    (16, torch.float32, False, True), (16, torch.float32, True, True),
    (64, torch.float32, False, True), (64, torch.float32, True, True),
    (64, torch.bfloat16, True, True), (128, torch.bfloat16, False, False),
    (4, torch.float32, False, False)])
def test_window_wrappers_take_their_head_sizes(D, dtype, backward, taken):
    """A head size the kernel takes gets past the head check (and stops at
    the CPU tensors); another raises, naming the sizes taken."""
    q = torch.zeros(1, 8, 16, 2 * D, dtype=dtype)
    keep = torch.ones(1, 8, 16)
    args = ([q], [q], [q], [keep]) + (([q],) if backward else ())
    fn = _ext.window_attn_bwd if backward else _ext.window_attn_fwd
    match = "CUDA device" if taken else r"\(8, 16, 32, 64\)"
    with pytest.raises(ValueError, match=match):
        fn(*args, 2)
