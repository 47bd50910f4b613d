"""Flip and multi-scale test-time augmentation: the port against the JAX
package, f32 on the CPU.

- ``box_nms_keep`` on seeded boxes with near-duplicates and tied scores
  (equal masks at three score thresholds); ``merge_aug_detections`` on the
  two passes of ``tests/test_videopose_model.py``'s merge test (the same
  kept detections); ``_rescale_batch`` bit for bit on uint8 and float32
  batches of two valid sizes (the uint8 feed is resized as uint8, as JAX
  resizes the same numpy batch).
- ``forward_test_flip`` and ``forward_test_aug`` (plain and flipped) of the
  tiny model of ``tests/test_torch_videopose.py`` on two clips of
  different valid widths, so that the flip inside each clip's width
  shows, and the merge of those two passes; one JAX compile.
- ``run_inference`` of the tiny debug config with ``flip_test`` and
  ``aug_scales=[1.0, 0.75]`` over the 8 val clips of the synthetic scenes
  (uint8 test chain; the 0.75 scale lands in another bucket).

Weights as in ``tests/test_torch_eval_cli.py``: the port's seeded init
laid onto ``jax.eval_shape`` of the JAX init and noised. The merged
outputs keep ``max_per_img`` slots of which the kept ones are finite;
``jax.lax.top_k`` and ``torch.topk`` order the ``-inf`` slots
differently, so only kept entries are compared: the same keep mask,
keypoints within 1e-2 px, scores within 1e-5 (as the serving tests).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.apis import test as jtest
from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader
from pavenet_tpu.datasets.pipelines import transforms as jtf
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu.ops.nms import box_nms_keep as j_box_nms_keep
from pavenet_tpu_torch.apis import test as ttest
from pavenet_tpu_torch.apis.inference import build_model
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.datasets import ClipLoader
from pavenet_tpu_torch.datasets.pipelines import transforms as tf
from pavenet_tpu_torch.models import VideoPoseDetector
from pavenet_tpu_torch.ops.nms import box_nms_keep
from pavenet_tpu_torch.utils.weight_convert import load_jax_variables
from tests.test_torch_eval_cli import SCENES, TINY as TINY_CONFIG, datasets
from tests.test_torch_trainable_bn import port_weights_on_jax_tree
from tests.test_torch_videopose import TINY

t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def person(cx, cy, K=15, size=10.0):
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    return np.stack([cx + size * np.cos(ang), cy + size * np.sin(ang),
                     np.ones(K)], -1).astype(np.float32)


def make_pass(persons, scores, M=5, K=15):
    kpts = np.zeros((1, M, K, 3), np.float32)
    sc = np.zeros((1, M), np.float32)
    for i, (p, s) in enumerate(zip(persons, scores)):
        kpts[0, i], sc[0, i] = p, s
    return dict(det_kpts=kpts, scores=sc)


def kept(out, b=0):
    """Kept slots of image ``b``, best first: (scores, keypoints,
    boxes)."""
    keep = np.asarray(out["keep"][b])
    scores = np.asarray(out["det_bboxes"][b, :, 4])[keep]
    order = np.argsort(-scores, kind="stable")
    return (scores[order], np.asarray(out["det_kpts"][b])[keep][order],
            np.asarray(out["det_bboxes"][b, :, :4])[keep][order])


def assert_same_kept(got, want, B=1):
    for b in range(B):
        assert int(np.sum(got["keep"][b])) == int(np.sum(want["keep"][b]))
        gs, gk, gb = kept(got, b)
        ws, wk, wb = kept(want, b)
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gk, wk, atol=1e-2, rtol=0)
        np.testing.assert_allclose(gb, wb, atol=1e-2, rtol=0)


def test_box_nms_merge_and_rescale_match_jax():
    rng = np.random.RandomState(0)
    xy = rng.rand(40, 2).astype(np.float32) * 100
    wh = rng.rand(40, 2).astype(np.float32) * 30 + 5
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[20:30] = boxes[:10] + rng.randn(10, 4).astype(np.float32)
    scores = rng.rand(40).astype(np.float32)
    scores[30:35] = scores[0]                       # ties
    for score_thr in (0.0, 0.3, 0.9):
        want = np.asarray(j_box_nms_keep(jnp.asarray(boxes),
                                         jnp.asarray(scores), 0.7,
                                         score_thr))
        got = box_nms_keep(t(boxes), t(scores), 0.7, score_thr).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < 40 or score_thr == 0.9

    p1, p2, p3 = person(30, 30), person(70, 30), person(30, 80)
    passes = [make_pass([p1, p2], [0.9, 0.8]),
              make_pass([person(30.5, 30.2), p3], [0.85, 0.6])]
    jmodel = JDetector(max_per_img=5)
    want = jax.device_get(jmodel.apply(
        {}, [{k: jnp.asarray(v) for k, v in o.items()} for o in passes],
        method="merge_aug_detections"))
    model = VideoPoseDetector(**dict(TINY, max_per_img=5))
    got = {k: v.numpy() for k, v in model.merge_aug_detections(
        [{k: t(v) for k, v in o.items()} for o in passes]).items()}
    assert_same_kept(got, want)
    assert kept(got)[0].tolist() == pytest.approx([0.9, 0.8, 0.6])

    for dtype in (np.uint8, np.float32):
        batch = dict(img=(rng.rand(2, 3, 192, 256, 3) * 255).astype(dtype),
                     img_shape=np.array([[96, 128], [90, 121]], np.int32),
                     scale_factor=np.array([[1.25, 1.25], [0.8, 0.8]],
                                           np.float32))
        for ratio in (1.0, 0.75, 0.5):
            want = jtest._rescale_batch(dict(batch), ratio)
            got = ttest._rescale_batch(dict(batch), ratio)
            assert got["img"].dtype == want["img"].dtype == dtype
            for k in ("img", "img_shape", "scale_factor"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flip_and_aug_passes_match_jax():
    rng = np.random.RandomState(3)
    batch = dict(img=rng.randn(2, 3, 64, 96, 3).astype(np.float32),
                 img_shape=np.array([[64, 96], [58, 77]], np.int32),
                 scale_factor=np.array([[0.6945, 0.6945], [1.5, 1.5]],
                                       np.float32))
    jmodel = JDetector(max_gt=4, **TINY)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, train=False), batch)
    model = VideoPoseDetector(**TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    load_jax_variables(model, variables)
    model.eval()

    @jax.jit
    def run(v, b):
        flip = jmodel.apply(v, b, method=jmodel.forward_test_flip)
        passes = [jmodel.apply(v, b, flip=f, method=jmodel.forward_test_aug)
                  for f in (False, True)]
        merged = jmodel.apply(v, passes, method=jmodel.merge_aug_detections)
        return flip, passes, merged

    want_flip, want_passes, want_merged = jax.device_get(run(variables,
                                                             batch))
    tb = {k: t(v) for k, v in batch.items()}
    passes = [model.forward_test_aug(tb, flip=f) for f in (False, True)]
    for p, w in zip(passes, want_passes):
        np.testing.assert_allclose(p["det_kpts"].numpy(), w["det_kpts"],
                                   atol=1e-2, rtol=0)
        np.testing.assert_allclose(p["scores"].numpy(), w["scores"],
                                   atol=1e-5, rtol=0)
    # the selection hook: a pass given its own clip's top-k is the same pass
    for f, p in zip((False, True), passes):
        seen = model._flip_images(tb) if f else tb
        topk = model.forward_outputs(seen["img"], seen["img_shape"])[
            "topk_idx"]
        hooked = model.forward_test_aug(tb, flip=f, topk_idx=topk)
        assert all(torch.equal(hooked[k], p[k]) for k in p)
    # the flipped clip is another input: its detections differ
    assert not np.allclose(want_passes[0]["scores"],
                           want_passes[1]["scores"])
    for got, want in ((model.forward_test_flip(tb), want_flip),
                      (model.merge_aug_detections(passes), want_merged)):
        got = {k: v.numpy() for k, v in got.items()}
        assert got["det_kpts"].shape == (2, 5, 15, 3)
        assert_same_kept(got, want, B=2)
        assert np.all(got["det_kpts"][got["keep"]][..., 2] == 1.0)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from pavenet_tpu_torch.datasets import synthetic
    root = tmp_path_factory.mktemp("scenes")
    synthetic.main(["--root", str(root)] + SCENES)
    return root


def test_run_inference_flip_and_scales_match_jax(scenes):
    """The tiny model over the 8 val clips, uint8 test chain on both
    sides, each clip at scales 1.0 and 0.75, each plain and flipped."""
    jmodel = jax_build_detector(JConfig.fromfile(TINY_CONFIG).model)
    model = build_model(TINY_CONFIG, seed=0)
    batch = dict(img=np.zeros((1, 3, 192, 256, 3), np.float32),
                 img_shape=np.array([[96, 128]], np.int32),
                 scale_factor=np.ones((1, 2), np.float32))
    shapes = jax.eval_shape(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, train=False), batch)
    variables = port_weights_on_jax_tree(model, shapes, seed=1)
    load_jax_variables(model, variables)
    model.eval()
    kwargs = dict(Config.fromfile(TINY_CONFIG).test_pipeline_kwargs,
                  normalize_on_device=True)
    jds, ds = datasets(scenes, pipelines=(
        jtf.build_test_pipeline(**kwargs), tf.build_test_pipeline(**kwargs)))
    opts = dict(batch_size=1, shuffle=False, drop_last=False)
    tta = dict(flip_test=True, aug_scales=[1.0, 0.75])
    want = jtest.run_inference(jmodel, variables, JClipLoader(jds, **opts),
                               **tta)
    got = ttest.run_inference(model, ClipLoader(ds, **opts), **tta)
    assert 0 < len(got) == len(want)
    key = lambda d: (d["image_id"], -d["score"])   # noqa: E731
    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert g["image_id"] == w["image_id"]
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5, rtol=0)
        gk = np.asarray(g["keypoints"]).reshape(-1, 3)
        wk = np.asarray(w["keypoints"]).reshape(-1, 3)
        np.testing.assert_allclose(gk, wk, atol=1e-2, rtol=0)
    metrics = ttest.evaluate_dataset(ds, got)
    for k, v in jtest.evaluate_dataset(jds, want).items():
        np.testing.assert_allclose(metrics[k], v, atol=1e-6, rtol=0,
                                   err_msg=k)
