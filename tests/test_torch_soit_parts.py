"""SOIT's and DK-DETR's parts in the port against the JAX package, no JAX
compile: eager JAX calls and ``jax.eval_shape``.

- ``make_sampling_locations`` in box form (SOIT's decoder) and point form,
  within 1e-6.
- The box utilities, ``giou``, ``rel_sine_positional_encoding`` (the port
  batched over images and instances, JAX per instance) and
  ``aligned_bilinear`` at factors 4 and 2, within 1e-5 (2e-5 for the
  encoding's sines of arguments up to 2*pi*10).
- ``dynamic_mask_attention``: the port's instances folded into one msda
  query axis, JAX's per instance with ``impl='xla'``, within 1e-5; and
  every msda call of a tiny SOIT's ``forward_test``, the mask call
  included, takes the model's ``impl`` (none pinned to the plain
  version, so the card runs the kernels on all of them).
- The GT-mask resize of ``forward_train``: ``F.interpolate(bilinear,
  antialias=True)`` against ``jax.image.resize(bilinear)`` within 1e-5, at
  an exact half and where the target is no exact half; without
  antialiasing the two are 0.4 apart.
- Every config under ``configs/soit/`` and ``configs/dk-detr/`` builds on
  the meta device; SOIT R50 and DK-DETR LVIS have every key and shape of
  the JAX init's tree; the optimizer labels equal JAX's on DK-DETR's tree
  (trainable BatchNorm); ``soit_r50_coco`` is the R50 config's model.
"""
import glob
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pavenet_tpu.apis import train as jtrain
from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models import builder as jbuilder
from pavenet_tpu.models.attention.deformable import (
    make_sampling_locations as j_locations)
from pavenet_tpu.models.detectors import soit as jsoit
from pavenet_tpu_torch.apis import train as ttrain
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import soit_r50_coco
from pavenet_tpu_torch.models.attention.deformable import (
    make_sampling_locations)
from pavenet_tpu_torch.models.builder import build_detector
from pavenet_tpu_torch.models.detectors import soit
from tests.test_torch_swin import converted_shapes
from tests.test_torch_soit import TINY, det_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t = torch.from_numpy


def test_box_and_point_sampling_locations_match_jax():
    rng = np.random.RandomState(0)
    levels = ((9, 13), (5, 7), (3, 4), (2, 2))
    offsets = rng.randn(2, 7, 8, 4, 4, 2).astype(np.float32) * 3
    for width in (4, 2):
        ref = rng.uniform(-0.2, 1.2, (2, 7, 4, width)).astype(np.float32)
        want = np.asarray(j_locations(ref, offsets, levels, 4))
        got = make_sampling_locations(t(ref), t(offsets), levels, 4).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str(width))
    with pytest.raises(ValueError, match="2 or 4"):
        make_sampling_locations(torch.zeros(2, 7, 4, 3), t(offsets), levels,
                                4)


def test_box_utils_encoding_and_upsample_match_jax():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 50, (6, 5, 4)).astype(np.float32)
    b = rng.uniform(0, 50, (6, 5, 4)).astype(np.float32)
    for boxes in (a, b):
        boxes[..., 2:] += boxes[..., :2]
    np.testing.assert_allclose(soit.giou(t(a), t(b)).numpy(),
                               np.asarray(jsoit.giou(a, b)), atol=1e-6)
    np.testing.assert_allclose(
        soit.xyxy_to_cxcywh(soit.cxcywh_to_xyxy(t(a))).numpy(),
        np.asarray(jsoit.xyxy_to_cxcywh(jsoit.cxcywh_to_xyxy(a))),
        atol=1e-6)
    # (B, h, w) padding masks and (B, M, 2) centres
    mask = np.zeros((2, 9, 13), bool)
    mask[0, :, 11:] = True
    mask[1, 7:] = True
    centers = rng.uniform(-0.2, 1.2, (2, 3, 2)).astype(np.float32)
    got = soit.rel_sine_positional_encoding(t(mask), t(centers)).numpy()
    for i in range(2):
        for m in range(3):
            want = np.asarray(jsoit.rel_sine_positional_encoding(
                mask[i], centers[i, m]))
            np.testing.assert_allclose(got[i, m], want, atol=2e-5)
    for shape, factor in (((2, 3, 9, 13), 4), ((1, 5, 7, 4), 4),
                          ((2, 2, 6, 5), 2)):
        x = rng.randn(*shape).astype(np.float32)
        np.testing.assert_allclose(
            soit.aligned_bilinear(t(x), factor).numpy(),
            np.asarray(jsoit.aligned_bilinear(x, factor)), atol=1e-5,
            err_msg=str(shape))


def test_dynamic_mask_attention_matches_jax():
    rng = np.random.RandomState(2)
    B, M, h0, w0 = 2, 3, 9, 13
    n0 = h0 * w0
    params = (rng.randn(B, M, 441) * 0.5).astype(np.float32)
    feat = rng.randn(B, n0, 8).astype(np.float32)
    mask = np.zeros((B, h0, w0), bool)
    mask[0, :, 11:] = True
    mask[1, 6:] = True
    centers = rng.uniform(0, 1, (B, M, 2)).astype(np.float32)
    refs = rng.uniform(0, 1, (B, n0, 1, 2)).astype(np.float32)
    pos = soit.rel_sine_positional_encoding(t(mask), t(centers))
    got = soit.dynamic_mask_attention(
        t(params), t(feat), pos.reshape(B, M, n0, 8), t(refs), (h0, w0),
        t(mask.reshape(B, n0))).numpy()
    for i in range(B):
        for m in range(M):
            jpos = jsoit.rel_sine_positional_encoding(mask[i], centers[i, m])
            want = np.asarray(jsoit.dynamic_mask_attention(
                params[i, m], feat[i], jpos.reshape(n0, 8), refs[i],
                (h0, w0), mask[i].reshape(n0), impl="xla"))
            np.testing.assert_allclose(got[i, m], want, atol=1e-5,
                                       err_msg=f"image {i} slot {m}")


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_every_msda_call_takes_the_models_impl(impl, monkeypatch):
    """The tiny SOIT's 4 layer calls (encoder, seg encoder, 2 decoder
    layers) and its dynamic mask call (the detector module's own, 6
    detections x the level-0 tokens on the query axis) each pass the
    model's ``impl``. The calls are recorded and run on the plain version,
    so that 'cuda' runs on the CPU too."""
    from pavenet_tpu_torch.models.attention import deformable
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    calls = []

    def recorder(site):
        def record(value, shapes, loc, attn, impl="auto"):
            calls.append((site, impl, loc.shape[1], value.shape[1]))
            return ms_deform_attn_torch(value, shapes, loc, attn)
        return record

    monkeypatch.setattr(deformable, "ms_deform_attn", recorder("layer"))
    monkeypatch.setattr(soit, "ms_deform_attn", recorder("mask"))
    torch.manual_seed(0)
    model = soit.SOITDetector(**TINY, dropout=0.0, impl=impl).eval()
    out = model.forward_test({k: t(v) for k, v in det_batch().items()})
    assert [site for site, *_ in calls] == ["layer"] * 4 + ["mask"]
    assert {call_impl for _, call_impl, _, _ in calls} == {impl}
    _, _, Q, n0 = calls[-1]
    assert Q == TINY["max_per_img"] * n0
    assert out["det_masks"].shape[:2] == (2, TINY["max_per_img"])


@pytest.mark.parametrize("size,target", [((64, 96), (32, 48)),
                                         ((68, 100), (36, 52))])
def test_gt_mask_resize_matches_jax_antialiased(size, target):
    masks = (np.random.RandomState(3).rand(2, 4, *size) > 0.7).astype(
        np.float32)
    want = np.asarray(jax.image.resize(masks, (2, 4, *target),
                                       method="bilinear"))
    got = F.interpolate(t(masks), size=target, mode="bilinear",
                        align_corners=False, antialias=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    plain = F.interpolate(t(masks), size=target, mode="bilinear",
                          align_corners=False).numpy()
    assert np.abs(plain - want).max() > 0.4


def test_every_soit_and_dkdetr_config_builds_with_the_jax_tree():
    configs = sorted(glob.glob(os.path.join(REPO, "configs/soit/*.py"))
                     + glob.glob(os.path.join(REPO, "configs/dk-detr/*.py")))
    assert len(configs) == 7
    for path in configs:
        with torch.device("meta"):
            model = build_detector(Config.fromfile(path).model)
        jmodel = jbuilder.build_detector(JConfig.fromfile(path).model)
        for k in ("num_classes", "num_query", "max_gt", "max_per_img",
                  "cls_emb_dim", "temperature", "norm_eval",
                  "num_decoder_layers"):
            assert getattr(model, k) == getattr(jmodel, k), (path, k)
        assert model.loss_weights == dict(
            cls=jmodel.loss_cls_weight, bbox=jmodel.loss_bbox_weight,
            iou=jmodel.loss_iou_weight, dice=jmodel.dice_mask_loss_weight,
            bce=jmodel.bce_mask_loss_weight), path
    batch = {k: v for k, v in det_batch(B=1, H=128, W=192, G=30).items()}
    for config in ("soit/soit_r50_16x2_50e_coco.py",
                   "dk-detr/dkd_r50_70e_lvis.py"):
        path = os.path.join(REPO, "configs", config)
        with torch.device("meta"):
            model = build_detector(Config.fromfile(path).model)
        jmodel = jbuilder.build_detector(JConfig.fromfile(path).model)
        b = dict(batch, text_feats=np.zeros((1203, 512), np.float32))
        tree = jax.eval_shape(lambda x: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, x, train=True), b)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == converted_shapes(tree), config
        if model.cls_emb_dim:
            # the optimizer's groups, trainable BatchNorm affines included
            flat = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
            rename = {"kernel": "weight", "scale": "weight"}
            want = {".".join([p.key for p in path[:-1]] + [rename.get(
                path[-1].key, path[-1].key)]): jtrain._param_label(
                    path, trainable_bn=True, frozen_stages=1)
                for path, _ in flat}
            labels = ttrain.param_labels(model)
            assert labels == want
            assert {"frozen", "backbone", "backbone_norm", "slow",
                    "base"} == set(labels.values())
    with torch.device("meta"):
        zoo = soit_r50_coco()
        model = build_detector(Config.fromfile(os.path.join(
            REPO, "configs/soit/soit_r50_16x2_50e_coco.py")).model)
    assert ({k: v.shape for k, v in zoo.state_dict().items()}
            == {k: v.shape for k, v in model.state_dict().items()})
    assert (zoo.loss_weights, zoo.cost_weights) == (model.loss_weights,
                                                    model.cost_weights)
    assert ttrain.feed_keys(model) == ttrain.DET_KEYS
    assert ttrain.feed_keys(build_detector(Config.fromfile(os.path.join(
        REPO, "configs/soit/soit_tiny_debug.py")).model)) == ttrain.DET_KEYS
    with torch.device("meta"):
        dk = build_detector(Config.fromfile(os.path.join(
            REPO, "configs/dk-detr/dkd_r50_70e_test_voc.py")).model)
    assert ttrain.feed_keys(dk)[-1] == "text_feats"
