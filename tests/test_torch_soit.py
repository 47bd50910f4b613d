"""The port's SOIT detector against the JAX package's, f32 on the CPU.

The tiny SOIT of ``tests/test_soit.py`` (ResNet-18, ``embed_dims=32``, one
encoder layer, two decoder layers so that the refined boxes are detached
between layers, 12 queries, 5 classes, 6 detections), B=2 images at
68x100 (padding in each, 4 GT slots, the second image with one valid),
dropout 0: the JAX module fixes its dropout at 0.1, so the JAX side runs
with ``flax.linen.Dropout`` as the identity while this file traces it.
Weights: the port's seeded init laid onto ``jax.eval_shape`` of the JAX
init and noised, carried by ``utils/weight_convert.py`` and loaded
strictly. One JAX compile gives ``forward_test``, the matches of every
prediction set, the loss dict and every gradient.

The GT masks are at the input size, 68x100, and the x4 mask grid is 36x52:
not an exact half, where ``F.interpolate`` without antialiasing is 0.44
away from ``jax.image.resize`` (``tests/test_torch_soit_parts.py``).

Tolerances: boxes 1e-3 px, scores and mask probabilities 1e-5, labels
equal; matches equal; losses rtol 1e-5; gradients atol 1e-4 of each
tensor's largest plus 1e-7 (deep f32 sums; 9.5e-6 seen, at the neck's
extra convolution, whose GroupNorm at 32 channels is ill-conditioned).
Few test items on purpose: pytest-xdist's ``loadfile`` queue takes files
with more tests first, and this file's JAX compile should not delay the
suite's longest files.
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.models.detectors.soit import SOITDetector as JSOIT
from pavenet_tpu.models.detectors.soit import (cxcywh_to_xyxy as j_xyxy,
                                               xyxy_to_cxcywh as j_cxcywh)
from pavenet_tpu_torch.models.detectors.soit import SOITDetector
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

TINY = dict(num_classes=5, num_query=12, max_gt=4, backbone_depth=18,
            embed_dims=32, num_encoder_layers=1, num_decoder_layers=2,
            feedforward_channels=64, max_per_img=6)
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def det_batch(seed=0, B=2, H=68, W=100, G=4, num_classes=5):
    """Seeded boxes inside each image's valid region, labels, binary masks
    at the input size and validity (3 and 1 valid slots)."""
    rng = np.random.RandomState(seed)
    img_shape = np.array([[H, W - 10], [H - 8, W]], np.int32)[:B]
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, 40, (B, G))
    boxes[..., 1] = rng.uniform(0, 30, (B, G))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(10, 40, (B, G))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(10, 25, (B, G))
    valid = np.zeros((B, G), bool)
    valid[0, :3] = True
    valid[1:, 0] = True
    return dict(
        img=rng.randn(B, H, W, 3).astype(np.float32), img_shape=img_shape,
        scale_factor=rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32),
        gt_boxes=boxes,
        gt_labels=rng.randint(0, num_classes, (B, G)).astype(np.int64),
        gt_masks=(rng.rand(B, G, H, W) > 0.6).astype(np.float32),
        gt_valid=valid)


def jax_matches(module, b):
    """The JAX detector's matches of every prediction set (decoder layers,
    then the encoder's binary-label set), as its ``forward_train`` makes
    them."""
    outs = module.forward_outputs(b["img"], b["img_shape"],
                                  deterministic=False,
                                  text_feats=b.get("text_feats"))
    assign = jax.vmap(module._assign)
    sets = [(outs["all_cls_scores"][d], outs["all_bbox_preds"][d],
             b["gt_labels"]) for d in range(outs["all_cls_scores"].shape[0])]
    sets.append((outs["enc_cls_scores"],
                 j_cxcywh(j_xyxy(outs["enc_bbox_preds"])),
                 jax.numpy.zeros_like(b["gt_labels"])))
    return [assign(c, bx, b["gt_boxes"], lab, b["gt_valid"], b["img_shape"])
            for c, bx, lab in sets]


def jax_step(jmodel, variables, batch):
    """One jitted JAX call: ``forward_test``, the matches, the loss dict and
    every gradient, with dropout the identity while it traces."""
    @jax.jit
    def run(v, b):
        def loss_fn(params):
            losses = jmodel.apply(dict(v, params=params), b, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(2)})
            return losses["loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        det = jmodel.apply(v, b, method=jmodel.forward_test)
        matches = jmodel.apply(v, b, method=jax_matches,
                               rngs={"dropout": jax.random.PRNGKey(2)})
        return det, matches, losses, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        return jax.device_get(run(variables, batch))


def port_step(model, batch):
    """The port's detections (eval mode), matches, losses and gradients."""
    tb = {k: t(v) for k, v in batch.items()}
    model.eval()
    det = {k: v.numpy() for k, v in model.forward_test(tb).items()}
    model.train()
    with torch.no_grad():
        matches = [q.numpy() for q in model.match(
            model.forward_outputs(tb["img"], tb["img_shape"], train=True,
                                  text_feats=tb.get("text_feats")), tb)]
    losses = model.forward_train(tb)
    losses["loss"].backward()
    return det, matches, {k: v.item() for k, v in losses.items()}


@pytest.fixture(scope="module")
def tiny_soit():
    batch = det_batch()
    jmodel = JSOIT(**TINY)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)
    model = SOITDetector(dropout=0.0, **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)
    jdet, jmatches, jlosses, jgrads = jax_step(jmodel, variables, batch)
    det, matches, losses = port_step(model, batch)
    return dict(model=model, det=det, jdet=jdet, matches=matches,
                jmatches=jmatches, losses=losses, jlosses=jlosses,
                jgrads=jax_variables_to_state_dict({"params": jgrads}))


def check_detections(got, want):
    assert got["det_masks"].shape == (2, 6, 36, 52)
    np.testing.assert_array_equal(got["det_labels"], want["det_labels"])
    np.testing.assert_allclose(got["det_bboxes"][..., :4],
                               want["det_bboxes"][..., :4], atol=1e-3)
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    np.testing.assert_allclose(got["det_masks"], want["det_masks"],
                               atol=1e-5)


def check_gradients(model, jgrads, rel=1e-4):
    params = dict(model.named_parameters())
    assert set(jgrads) == set(params)
    for name, p in params.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        w = np.asarray(jgrads[name])
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max() + 1e-7,
                                   rtol=0, err_msg=name)


def test_tiny_soit_serving_matches_jax(tiny_soit):
    check_detections(tiny_soit["det"], tiny_soit["jdet"])


def test_tiny_soit_train_losses_matches_and_gradients_match_jax(tiny_soit):
    """Every loss (the per-layer, encoder and mask losses), the matches of
    all three prediction sets and every parameter's gradient: a missing
    detach of the refined boxes, the top-k proposals or the mask centres
    shows here."""
    for got, want in zip(tiny_soit["matches"], tiny_soit["jmatches"]):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(tiny_soit["matches"]) == 3
    want, got = tiny_soit["jlosses"], tiny_soit["losses"]
    assert set(got) == set(want) and {
        "d0.loss_cls", "loss_iou", "enc_loss_bbox", "loss_mask_dice",
        "loss_mask_bce"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    check_gradients(tiny_soit["model"], tiny_soit["jgrads"])
