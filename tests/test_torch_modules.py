"""Each ported module against its JAX counterpart on the same weights.

The JAX module is initialised, every leaf of its variables gets seeded numpy
noise (so zero-initialised kernels cannot hide a transposition), the tree is
converted with ``jax_variables_to_state_dict`` and loaded into the port with
``strict=True``, and both sides run the same numpy inputs in f32 on the CPU.
Tolerance ``atol=rtol=1e-4``: deep f32 convolution and matmul sums in
another order (JAX runs at ``highest`` precision, see conftest).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.models.attention import deformable as jdef
from pavenet_tpu.models.backbones.resnet import ResNet as JResNet
from pavenet_tpu.models.layers import transformer as jtr
from pavenet_tpu.models.layers.positional_encoding import (
    sine_positional_encoding as j_sine)
from pavenet_tpu.models.necks.channel_mapper import (
    ChannelMapper as JChannelMapper)
from pavenet_tpu_torch.models.attention import deformable as tdef
from pavenet_tpu_torch.models.backbones.resnet import ResNet
from pavenet_tpu_torch.models.layers import transformer as ttr
from pavenet_tpu_torch.models.layers.positional_encoding import (
    sine_positional_encoding)
from pavenet_tpu_torch.models.necks.channel_mapper import ChannelMapper
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict

SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))   # a 64x96 image's levels
N_TOK = sum(h * w for h, w in SHAPES)


def noised(variables, seed=0, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(
            np.float32), jax.device_get(variables))


def port_with(module, variables):
    module.load_state_dict(jax_variables_to_state_dict(variables),
                           strict=True)
    return module.eval()


def init_apply(jmodule, *args, **kwargs):
    """Jitted init, noised variables, and the JAX output on ``args``."""
    init = jax.jit(functools.partial(jmodule.init, **kwargs))
    variables = noised(init(jax.random.PRNGKey(0), *args))
    out = jax.jit(functools.partial(jmodule.apply, **kwargs))(variables, *args)
    return variables, jax.tree.map(np.asarray, out)


def case_resnet(depth):
    rng = np.random.RandomState(depth)
    img = rng.randn(2, 64, 96, 3).astype(np.float32)
    variables, want = init_apply(JResNet(depth=depth,
                                         out_indices=(0, 1, 2, 3)), img)
    port = port_with(ResNet(depth, (0, 1, 2, 3)), variables)
    got = port(torch.from_numpy(img).permute(0, 3, 1, 2))
    return [g.permute(0, 2, 3, 1) for g in got], want


def case_channel_mapper():
    rng = np.random.RandomState(1)
    chans = (16, 24, 40)
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for (h, w), c in zip(SHAPES[:3], chans)]
    variables, want = init_apply(JChannelMapper(out_channels=64), feats)
    port = port_with(ChannelMapper(chans, 64), variables)
    got = port([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    return [g.permute(0, 2, 3, 1) for g in got], want


def case_sine_positional_encoding():
    mask = np.ones((2, 8, 12), bool)       # True = padded
    mask[0, :7, :10] = False
    mask[1, :6, :5] = False
    want = np.asarray(j_sine(mask, num_feats=16))
    return sine_positional_encoding(torch.from_numpy(mask), num_feats=16), want


def case_mlp():
    x = np.random.RandomState(2).randn(2, 5, 32).astype(np.float32)
    variables, want = init_apply(
        jtr.MLP((48, 48), 30, zero_init_last=True), x)
    port = port_with(ttr.MLP(32, (48, 48), 30), variables)
    return port(torch.from_numpy(x)), want


def case_ffn():
    x = np.random.RandomState(3).randn(2, 5, 32).astype(np.float32)
    variables, want = init_apply(jtr.FFN(32, 64), x)
    port = port_with(ttr.FFN(32, 64), variables)
    return port(torch.from_numpy(x)), want


def case_mha():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 7, 32).astype(np.float32)
    pos = rng.randn(3, 7, 32).astype(np.float32)
    variables, want = init_apply(jtr.MultiheadAttention(32, 8), x,
                                 query_pos=pos)
    port = port_with(ttr.MultiheadAttention(32, 8), variables)
    return port(torch.from_numpy(x), torch.from_numpy(pos)), want


def case_msda_encoder():
    rng = np.random.RandomState(5)
    B, C = 2, 32
    x = rng.randn(B, N_TOK, C).astype(np.float32)
    pos = rng.randn(B, N_TOK, C).astype(np.float32)
    ref = rng.rand(B, N_TOK, 4, 2).astype(np.float32)
    mask = rng.rand(B, N_TOK) < 0.2
    kw = dict(spatial_shapes=SHAPES, key_padding_mask=mask, query_pos=pos)
    variables, want = init_apply(
        jdef.MultiScaleDeformableAttention(C, num_heads=4), x, x, ref, **kw)
    port = port_with(tdef.MultiScaleDeformableAttention(C, 4), variables)
    t = torch.from_numpy
    return port(t(x), t(x), t(ref), SHAPES, key_padding_mask=t(mask),
                query_pos=t(pos)), want


def _multi_frame_case(jcls, tcls, P, ref_last, seed):
    rng = np.random.RandomState(seed)
    B, T, Q, C = 1, 3, 6, 32
    q = rng.randn(B, Q, C).astype(np.float32)
    pos = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, T, N_TOK, C).astype(np.float32)
    ref = rng.rand(B, T, Q, 4, ref_last).astype(np.float32)
    mask = rng.rand(B, T, N_TOK) < 0.2
    kw = dict(spatial_shapes=SHAPES, key_padding_mask=mask, query_pos=pos)
    variables, want = init_apply(
        jcls(num_frames=T, embed_dims=C, num_heads=4, num_points=P),
        q, value, ref, **kw)
    port = port_with(tcls(T, C, 4, 4, P), variables)
    t = torch.from_numpy
    return port(t(q), t(value), t(ref), SHAPES, key_padding_mask=t(mask),
                query_pos=t(pos)), want


CASES = {
    "resnet18": functools.partial(case_resnet, 18),
    "resnet50": functools.partial(case_resnet, 50),
    "channel_mapper": case_channel_mapper,
    "sine_positional_encoding": case_sine_positional_encoding,
    "mlp": case_mlp,
    "ffn": case_ffn,
    "multihead_attention": case_mha,
    "msda_encoder": case_msda_encoder,
    "multi_frame_deformable": functools.partial(
        _multi_frame_case, jdef.MultiFrameDeformableAttention,
        tdef.MultiFrameDeformableAttention, 4, 2, 6),
    "multi_frame_pose_deformable": functools.partial(
        _multi_frame_case, jdef.MultiFramePoseDeformableAttention,
        tdef.MultiFramePoseDeformableAttention, 15, 30, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_parity(case):
    with torch.no_grad():
        got, want = CASES[case]()
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)
