"""The port's Swin backbone and the Swin PAVE-Net against the JAX package,
on the CPU.

- The tiny Swin of ``tests/test_swin.py`` (embed 32, depths 2/2/2/2, heads
  2/4/8/16, window 4) on a 60x92 input, so that every stage pads to the
  window and stage 3's 2x3 map falls below it (mmdet still shifts there):
  the JAX init, noised with seeded numpy, carried by
  ``utils/weight_convert.py`` and a strict load; each output stage within
  1e-5 of the largest value in f32, and within 6e-2 of it with both sides
  in bf16 (flax's dtype policy; the chip check's ``BF16_STAGE_TOL``).
- A tiny Swin PAVE-Net (the tiny debug detector of
  ``tests/test_torch_videopose.py`` with that Swin in place of the
  ResNet), B=2 clips of T=3 at 64x96, dropout 0: the port's seeded init
  laid onto ``jax.eval_shape`` of the JAX init and noised; one JAX compile
  gives ``forward_test``, the loss dict and every gradient. Detections as
  in ``tests/test_torch_videopose.py`` (keypoints 1e-2 px, scores 1e-5),
  losses rtol 1e-4, gradients atol 1e-4 / rtol 1e-3 (as
  ``tests/test_torch_train.py``).
- The full-width configs (Swin-L T=3 on PoseTrack18, R50 T=5 on
  PoseTrack17) built by the port's builder on the meta device: the
  state dict has every key and shape of the JAX variable tree, converted.

Few test items on purpose: pytest-xdist's ``loadfile`` queue takes files
with more tests first, and this file's JAX compile should not delay the
suite's longest files.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models.backbones.swin import SwinTransformer as JSwin
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import VideoPoseDetector, build_detector
from pavenet_tpu_torch.models.backbones.swin import SwinTransformer
from pavenet_tpu_torch.utils import weight_convert
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN = dict(embed_dims=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
            window_size=4)
TINY = dict(num_frames=3, num_keypoints=15, num_query=12,
            backbone_type="swin", swin_embed_dims=32,
            swin_depths=(2, 2, 2, 2), swin_num_heads=(2, 4, 8, 16),
            swin_window_size=4, embed_dims=64, num_encoder_layers=1,
            num_decoder_layers=2, num_refine_layers=1, max_per_img=5,
            dropout=0.0)
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noised(variables, seed=0, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(
            np.float32), jax.device_get(variables))


def test_tiny_swin_stages_match_jax():
    x = np.random.RandomState(0).randn(1, 60, 92, 3).astype(np.float32)
    jswin = JSwin(out_indices=(1, 2, 3), **SWIN)
    variables = noised(jax.jit(lambda: jswin.init(jax.random.PRNGKey(0),
                                                  x))())
    for jdtype, dtype, tol in ((jnp.float32, torch.float32, 1e-5),
                               (jnp.bfloat16, torch.bfloat16, 6e-2)):
        want = jax.jit(lambda v: JSwin(out_indices=(1, 2, 3), dtype=jdtype,
                                       **SWIN).apply(v, x))(variables)
        swin = SwinTransformer(out_indices=(1, 2, 3), dtype=dtype, **SWIN)
        swin.load_state_dict(jax_variables_to_state_dict(
            {"params": variables["params"]}), strict=True)
        assert swin.out_channels == (64, 128, 256)
        with torch.no_grad():
            got = swin(t(x).permute(0, 3, 1, 2))
        # stages 1-3: 8x12 (padded to 8x12), 4x6 (8x8), 2x3 (4x4)
        assert [tuple(g.shape) for g in got] == [
            (1, 64, 8, 12), (1, 128, 4, 6), (1, 256, 2, 3)]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == dtype
            w = np.asarray(w, np.float32)
            err = np.abs(g.float().permute(0, 2, 3, 1).numpy() - w).max()
            assert err <= tol * np.abs(w).max(), (str(dtype), i, err)


@pytest.fixture(scope="module")
def swin_pavenet():
    """Both sides of the tiny Swin PAVE-Net on one batch: JAX's
    ``forward_test``, loss dict and gradients in one compile; the port's
    ``forward_test``, loss dict and gradients."""
    batch = j_dummy_clip_batch(np.random.RandomState(1), batch_size=2,
                               height=64, width=96, max_gt=8, train=True)
    jmodel = JDetector(max_gt=8, **TINY)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)
    model = VideoPoseDetector(**TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)

    @jax.jit
    def run(v, b):
        def loss_fn(params):
            losses = jmodel.apply({"params": params}, b, train=True)
            return losses["loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        det = jmodel.apply(v, b, method=jmodel.forward_test)
        return losses, grads, det

    jlosses, jgrads, jdet = jax.device_get(run(variables, batch))
    tb = {k: t(v) for k, v in batch.items()}
    model.eval()
    det = {k: v.numpy() for k, v in model.forward_test(tb).items()}
    model.train()
    losses = model.forward_train(tb)
    losses["loss"].backward()
    return dict(model=model, det=det, jdet=jdet, jlosses=jlosses,
                losses={k: v.item() for k, v in losses.items()},
                jgrads=jax_variables_to_state_dict({"params": jgrads}))


def test_swin_pavenet_matches_jax(swin_pavenet):
    got, want = swin_pavenet["det"], swin_pavenet["jdet"]
    assert got["det_kpts"].shape == (2, 5, 15, 3)
    np.testing.assert_allclose(got["det_kpts"], want["det_kpts"], atol=1e-2)
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    want, got = swin_pavenet["jlosses"], swin_pavenet["losses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    want = swin_pavenet["jgrads"]
    params = dict(swin_pavenet["model"].named_parameters())
    assert set(want) == set(params)
    # 8 blocks of norm1, qkv, the bias table, proj, norm2, fc1, fc2
    assert sum(n.startswith("backbone.stage") for n in params) == 8 * 13
    for name, p in params.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)


def converted_shapes(tree):
    """{port key: shape} of a JAX variable tree of shapes, by the
    converter's rules (on zero-stride arrays: no memory)."""
    out = {}
    for collection, names in (("params", None),
                              ("batch_stats", weight_convert.STATS)):
        shapes = jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)),
            tree.get(collection, {}))
        for path, leaf in weight_convert._walk(shapes):
            name, arr = ((names[path[-1]], leaf) if names
                         else weight_convert._param(path, leaf))
            out[".".join(path[:-1] + (name,))] = tuple(arr.shape)
    return out


def test_full_width_configs_build_with_the_jax_tree():
    for config, backbone_params in (
            ("pavenet_swin_frames3_posetrack18.py", 194_997_780),
            ("pavenet_r50_frames5_posetrack17.py", 23_508_032)):
        path = os.path.join(REPO, "configs/videopose", config)
        with torch.device("meta"):
            model = build_detector(Config.fromfile(path).model)
        jmodel = jax_build_detector(JConfig.fromfile(path).model)
        assert model.num_frames == jmodel.num_frames
        # 128x192: 510 tokens, enough for the 300 queries' top-k
        batch = j_dummy_clip_batch(np.random.RandomState(0), height=128,
                                   width=192, num_frames=model.num_frames,
                                   max_gt=jmodel.max_gt, train=True)
        tree = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, b, train=True), batch)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == converted_shapes(tree), config
        n = sum(p.numel() for k, p in model.named_parameters()
                if k.startswith("backbone."))
        assert n == backbone_params, config
