"""The port's PETR detector against the JAX package's, f32 on the CPU.

- ``center_focal_loss`` and ``oks_loss`` alone on seeded cases (positives
  where the target is exactly 1, the branch without positives; K=14, 15
  and 17 with instance weights and an average factor), within 1e-5.
- The tiny PETR of ``tests/test_petr_model.py`` at ``embed_dims=64`` and
  with two joint-decoder layers, so that both decoders detach between
  layers (R18, one encoder layer, two pose-decoder layers, 12 queries),
  B=2, T=1, 64x96, K=17, 4 GT slots, dropout 0: the
  port's seeded init laid onto ``jax.eval_shape`` of the JAX train-mode
  init (the heatmap branch included) and noised, carried by
  ``utils/weight_convert.py`` and loaded strictly. One JAX compile gives
  ``forward_test``, the loss dict and every gradient on a batch with
  ``gt_bboxes``, and the loss dict on the same batch without them (the
  heatmap radius from the keypoints' envelope). Detections: unit keypoint
  scores, ``keep`` all True, keypoints within 1e-2 px, scores within 1e-5;
  losses (``loss_hm``, ``loss_oks``, ``d*.loss_oks_refine`` included) rtol
  1e-4; gradients atol 1e-4 / rtol 1e-3 (as ``tests/test_torch_train.py``),
  which is where a wrong detach of the decoders' reference points shows.

Few test items on purpose: pytest-xdist's ``loadfile`` queue takes files
with more tests first, and this file's JAX compile should not delay the
suite's longest files.
"""
import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.models.losses.focal_loss import \
    center_focal_loss as j_center_focal_loss
from pavenet_tpu.models.losses.oks_loss import oks_loss as j_oks_loss
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu.models.zoo import petr_r50_coco as j_petr_r50_coco
from pavenet_tpu_torch.models.losses import center_focal_loss, oks_loss
from pavenet_tpu_torch.models.zoo import petr_r50_coco
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

TINY = dict(backbone_depth=18, embed_dims=64, num_encoder_layers=1,
            num_decoder_layers=2, num_refine_layers=2, num_query=12,
            max_per_img=5, feedforward_channels=64, dropout=0.0)
G = 4
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_heatmap_and_oks_losses_match_jax():
    rng = np.random.RandomState(0)
    # heatmaps with exact-1 centres, a padding mask, and no positive at all
    pred = rng.uniform(0, 1, (2, 6, 7, 17)).astype(np.float32)
    gt = np.clip(rng.uniform(-0.5, 1.2, pred.shape), 0, 1).astype(np.float32)
    mask = rng.rand(2, 6, 7) > 0.2
    for g, m in ((gt, mask), (gt, None), (np.minimum(gt, 0.99), mask)):
        want = float(j_center_focal_loss(pred, g, mask=m))
        got = center_focal_loss(t(pred), t(g),
                                mask=None if m is None else t(m)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (gt == 1).any() and not (np.minimum(gt, 0.99) == 1).any()
    for K in (14, 15, 17):
        n = 6
        preds = rng.uniform(0, 300, (n, 2 * K)).astype(np.float32)
        gts = (preds + rng.randn(n, 2 * K) * 20).astype(np.float32)
        valids = (rng.rand(n, K) > 0.3).astype(np.float32)
        areas = rng.uniform(1e3, 2e4, n).astype(np.float32)
        weight = (rng.rand(n) > 0.3).astype(np.float32)
        for linear in (False, True):
            want = float(j_oks_loss(preds, gts, valids, areas,
                                    num_keypoints=K, linear=linear,
                                    weight=weight, avg_factor=3.0))
            got = oks_loss(t(preds), t(gts), t(valids), t(areas),
                           num_keypoints=K, linear=linear,
                           weight=t(weight), avg_factor=3.0).item()
            np.testing.assert_allclose(got, want, rtol=1e-5)


def petr_batch():
    """The tiny PETR's batch: seeded keypoints, and boxes around each
    slot's visible keypoints with a seeded margin wide enough for heatmap
    radii of 1 and 2 cells (the envelope alone gives 0 at 64x96)."""
    batch = j_dummy_clip_batch(np.random.RandomState(1), batch_size=2,
                               num_frames=1, height=64, width=96,
                               num_keypoints=17, max_gt=G, train=True)
    rng = np.random.RandomState(2)
    kpts = batch["gt_keypoints"]
    vis = kpts[..., 2] > 0
    lo = np.where(vis[..., None], kpts[..., :2], np.inf).min(2)
    hi = np.where(vis[..., None], kpts[..., :2], -np.inf).max(2)
    margin = rng.uniform(16, 64, lo.shape).astype(np.float32)
    return dict(batch, gt_bboxes=np.concatenate(
        [lo - margin, hi + margin], -1).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_petr():
    """Both sides of the tiny PETR: JAX's ``forward_test``, loss dict and
    gradients with ``gt_bboxes`` and its loss dict without, in one
    compile; the port's the same."""
    batch = petr_batch()
    no_boxes = {k: v for k, v in batch.items() if k != "gt_bboxes"}
    jmodel = j_petr_r50_coco(max_gt=G, **TINY)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)
    assert "fc_hm" in shapes["params"]["head"]
    model = petr_r50_coco(**TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)

    @jax.jit
    def run(v, b, nb):
        def loss_fn(params):
            losses = jmodel.apply(dict(v, params=params), b, train=True)
            return losses["loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        det = jmodel.apply(v, b, method=jmodel.forward_test)
        return losses, grads, det, jmodel.apply(v, nb, train=True)

    jlosses, jgrads, jdet, jlosses_nb = jax.device_get(
        run(variables, batch, no_boxes))
    tb = {k: t(v) for k, v in batch.items()}
    model.eval()
    det = {k: v.numpy() for k, v in model.forward_test(tb).items()}
    model.train()
    with torch.no_grad():
        losses_nb = model.forward_train({k: t(v)
                                         for k, v in no_boxes.items()})
    losses = model.forward_train(tb)
    losses["loss"].backward()
    return dict(model=model, det=det, jdet=jdet,
                losses={k: v.item() for k, v in losses.items()},
                jlosses=jlosses,
                losses_nb={k: v.item() for k, v in losses_nb.items()},
                jlosses_nb=jlosses_nb,
                jgrads=jax_variables_to_state_dict({"params": jgrads}))


def test_tiny_petr_matches_jax(tiny_petr):
    got, want = tiny_petr["det"], tiny_petr["jdet"]
    assert got["det_kpts"].shape == (2, 5, 17, 3)
    assert got["keep"].all() and want["keep"].all()
    np.testing.assert_array_equal(got["det_kpts"][..., 2], 1.0)
    np.testing.assert_allclose(got["det_kpts"], want["det_kpts"], atol=1e-2)
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    for suffix in ("", "_nb"):
        want, got = tiny_petr["jlosses" + suffix], tiny_petr["losses" + suffix]
        assert set(got) == set(want)
        assert {"loss_hm", "loss_oks", "d0.loss_oks", "loss_kpt",
                "enc_loss_kpt", "d1.loss_kpt_refine",
                "d1.loss_oks_refine"} <= set(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k + suffix)
    # the boxes move the heatmap radius, so the two batches' loss_hm differ
    assert tiny_petr["losses"]["loss_hm"] != tiny_petr["losses_nb"]["loss_hm"]
    want = tiny_petr["jgrads"]
    params = dict(tiny_petr["model"].named_parameters())
    assert set(want) == set(params)
    assert any(n.startswith("head.hm_encoder_layer.") for n in params)
    for name, p in params.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, want[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)
