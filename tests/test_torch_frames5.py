"""T=5 clips: the port's PAVE-Net at ``num_frames=5`` against the JAX
package, f32 on the CPU.

The tiny T=5 model of ``tests/test_frames5.py`` (R18, one encoder, decoder
and joint-decoder layer, 10 queries, 4 detections, FFN 64), B=1 clip of 5
frames at 64x96 with 3 GT slots, dropout 0, except that ``embed_dims`` is
64 and not 32: at 32 the neck's GroupNorm holds one channel per group, and
on the 1x2 last level either side's f32 variance is off by about 1%
(``tests/test_torch_videopose.py``). Weights: the port's seeded init laid
onto ``jax.eval_shape`` of the JAX init, noised, converted and loaded
strictly; one JAX compile gives ``forward_test``, the loss dict and every
gradient.

Checked: the head's frame branches by JAX's names and order (4 aux stacks
``aux_kpt_branch_f{0..3}`` for pre_pre, pre, next, next_next around the
centre frame ``T // 2 = 2``; 5 refine stacks), ``forward_test``
(keypoints 1e-2 px, scores 1e-5, keep equal), the losses (rtol 1e-4) and
every gradient (atol 1e-4 / rtol 1e-3), as ``tests/test_torch_train.py``.
"""
import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu_torch.models import VideoPoseDetector
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

TINY5 = dict(num_frames=5, num_keypoints=15, num_query=10, backbone_depth=18,
             embed_dims=64, num_encoder_layers=1, num_decoder_layers=1,
             num_refine_layers=1, max_per_img=4, feedforward_channels=64,
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


@pytest.fixture(scope="module")
def frames5():
    batch = j_dummy_clip_batch(np.random.RandomState(0), batch_size=1,
                               num_frames=5, height=64, width=96,
                               num_keypoints=15, max_gt=3, train=True)
    jmodel = JDetector(max_gt=3, **TINY5)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)
    model = VideoPoseDetector(**TINY5)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)

    @jax.jit
    def run(v, b):
        def loss_fn(params):
            losses = jmodel.apply({"params": params,
                                   "batch_stats": v["batch_stats"]}, b,
                                  train=True)
            return losses["loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        return losses, grads, jmodel.apply(v, b,
                                           method=jmodel.forward_test)

    jlosses, jgrads, jdet = jax.device_get(run(variables, batch))
    tb = {k: t(v) for k, v in batch.items()}
    model.eval()
    det = {k: v.numpy() for k, v in model.forward_test(tb).items()}
    model.train()
    losses = model.forward_train(tb)
    losses["loss"].backward()
    return dict(shapes=shapes, model=model, det=det, jdet=jdet,
                jlosses=jlosses,
                losses={k: v.item() for k, v in losses.items()},
                jgrads=jax_variables_to_state_dict({"params": jgrads}))


def stacks(names, prefix):
    """The distinct ``{prefix}f{f}`` stacks of ``names``, in order."""
    return sorted({n.split("_l")[0] for n in names if n.startswith(prefix)})


def test_frame_branches_follow_jax_names(frames5):
    jhead = frames5["shapes"]["params"]["head"]
    head = {n.split(".")[1] for n, _ in
            frames5["model"].named_parameters() if n.startswith("head.")}
    for prefix, n in (("aux_kpt_branch_f", 4), ("refine_kpt_branch_f", 5)):
        assert stacks(jhead, prefix) == stacks(head, prefix)
        assert len(stacks(head, prefix)) == n
    assert frames5["model"].head.num_frames == 5


def test_frames5_forward_test_losses_and_gradients_match(frames5):
    got, want = frames5["det"], frames5["jdet"]
    assert got["det_kpts"].shape == (1, 4, 15, 3)
    np.testing.assert_allclose(got["det_kpts"], want["det_kpts"], atol=1e-2)
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    want, got = frames5["jlosses"], frames5["losses"]
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    want = frames5["jgrads"]
    params = dict(frames5["model"].named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)
