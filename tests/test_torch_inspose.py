"""The port's InsPose against the JAX package's, f32 on the CPU.

A tiny InsPose (ResNet-18, every tower 64 channels wide, one cls, ctrl and
keypoint tower convolution, two heatmap tower convolutions so that one
runs before and one after the bilinear x2, K=17, 6 detections) on B=2
images at 128x192 with 4 GT slots (3 and 1 valid). 128x192 and width 64
keep the comparison well conditioned: the FPN's five levels are 16x24 down
to 1x2, so the coarsest level's GroupNorm (32 groups of 2 channels) still
sees 4 values a group, where a 64x96 input would leave 2 (a 1x1 level)
and flax's one-pass variance and torch's two-pass one part at 1e-3.
Weights: the port's seeded init laid onto ``jax.eval_shape`` of the JAX
init and noised, carried by ``utils/weight_convert.py`` and loaded
strictly. One JAX compile gives the flattened level outputs, the top-k,
``forward_test``, the loss dict and every gradient.

The parts, each against its JAX function: the FPN (odd level sizes, so
the top-down crop shows), the x2 bilinear at the borders, ``DeformConvGN``
(the port's one folded msda call against JAX's 9 one-hot calls, forward and
the gradients to the input, the offsets and the parameters), soft-NMS,
varifocal loss, the FCOS assignment and the dynamic heatmaps. JAX's bf16
InsPose cannot serve (its soft-NMS loop's carry changes dtype; the
serving test shows it); the port decays bf16 scores in float32.

A tiny InsPose ``.pth`` (reference names, built by inverting the port's
rule table) goes through JAX's ``convert_inspose_state_dict(strict=True)``
and the port's rules, and serves through ``init_detector``; the tiny
config's ``init_trainer`` takes the config's optimizer and trains a step.

JAX's train CLI cannot train InsPose on COCO data: its loader's batch
holds a (B, T, H, W, 3) image and ``gt_bboxes``, and the JAX
``forward_train`` reads a (B, H, W, 3) image and ``gt_boxes``; the last
test shows both, and the port's train CLI adds no such feature.

Tolerances: level outputs, heatmaps and DeformConvGN 1e-5 of each tensor's
largest; keypoints 1e-2 px, boxes 1e-2 px, detection scores 1e-5, the
keypoints' heatmap scores 1e-4 (sigmoids of the dynamic FCN, three layers
whose weights are the controller's outputs, so their errors multiply:
2.8e-5 seen); losses rtol 1e-5; gradients 1e-4 of each tensor's largest
plus 1e-7, except the frozen stem and stage 1, 1e-3: their float32
gradients are sums that nearly cancel, and torch's CPU convolution
backward leaves them up to 6.0e-4 from the port's own float64 gradients
(JAX's float32: 1.5e-5), so the port also runs the step in float64 and
every gradient of that run is held to JAX's at 1e-4. Six test items on
purpose:
pytest-xdist's ``loadfile`` queue takes files with more tests first, and
this file's JAX compile should not delay the suite's longest files.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.detectors import inspose as jins
from pavenet_tpu.models.losses.focal_loss import varifocal_loss as j_vfl
from pavenet_tpu.models.necks.fpn import FPN as JFPN
from pavenet_tpu.ops.nms import soft_nms_scores as j_soft_nms
from pavenet_tpu.utils import weight_convert as jwc
from pavenet_tpu_torch.apis.inference import init_detector
from pavenet_tpu_torch.apis.train import (INSPOSE_KEYS, feed_keys,
                                          init_trainer, param_labels,
                                          train_step)
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import build_detector
from pavenet_tpu_torch.models.detectors import inspose
from pavenet_tpu_torch.models.losses import varifocal_loss
from pavenet_tpu_torch.models.necks import FPN
from pavenet_tpu_torch.ops.nms import soft_nms_scores
from pavenet_tpu_torch.utils.reference_convert import (
    convert_reference_state_dict, load_torch_checkpoint, reference_rules)
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_reference_ckpt import invert, leaves
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/inspose/inspose_r50_8x4_3x_coco.py")
TINY = dict(num_keypoints=17, backbone_depth=18, feat_channels=64,
            feat_channels_kpt=64, feat_channels_hm=64, shared_channels=64,
            stacked_convs=1, stacked_convs_kpt=1, stacked_convs_hm=2,
            max_per_img=6)
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pose_batch(seed=0, B=2, H=128, W=192, G=4, K=17):
    """Seeded boxes, keypoints inside them (a third invisible; the second
    image's first GT has none visible), 3 and 1 valid slots."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, 100, (B, G))
    boxes[..., 1] = rng.uniform(0, 60, (B, G))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(20, 90, (B, G))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(20, 60, (B, G))
    kpts = np.zeros((B, G, K, 3), np.float32)
    for i, lo, hi in ((0, 0, 2), (1, 1, 3)):
        kpts[..., i] = boxes[..., lo, None] + rng.rand(B, G, K) * (
            boxes[..., hi, None] - boxes[..., lo, None])
    kpts[..., 2] = (rng.rand(B, G, K) > 0.3) * 2.0
    kpts[1, 0, :, 2] = 0.0
    valid = np.zeros((B, G), bool)
    valid[0, :3] = True
    valid[1, 0] = True
    return dict(img=rng.randn(B, H, W, 3).astype(np.float32),
                img_shape=np.array([[H, W], [H - 8, W - 16]], np.int32)[:B],
                scale_factor=rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32),
                gt_boxes=boxes, gt_keypoints=kpts, gt_valid=valid)


def close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max() + 1e-7,
                               err_msg=what)


def carried(model, jmodule, *args, **kw):
    """The port's seeded init laid onto ``jmodule``'s JAX tree (noised),
    loaded strictly into ``model``; returns the JAX variables."""
    shapes = jax.eval_shape(lambda *a: jmodule.init(
        jax.random.PRNGKey(0), *a, **kw), *args)
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)
    return variables


# ---------------------------------------------------------------- parts
def test_fpn_upsample_and_deform_conv_match_jax():
    rng = np.random.RandomState(0)
    widths = (16, 24, 32, 40)
    feats = [rng.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(
        ((34, 49), (17, 25), (9, 13), (5, 7)), widths)]
    torch.manual_seed(0)
    fpn = FPN(widths, 32)
    jfpn = JFPN(out_channels=32)
    v = carried(fpn, jfpn, feats)
    want = jax.jit(jfpn.apply)(v, feats)
    got = fpn([t(f).permute(0, 3, 1, 2) for f in feats])
    assert [tuple(g.shape[-2:]) for g in got] == [
        (17, 25), (9, 13), (5, 7), (3, 4), (2, 2)]
    for lvl, (g, w) in enumerate(zip(got, want)):
        close(g.detach().permute(0, 2, 3, 1).numpy(), w, what=f"fpn {lvl}")

    # x2 bilinear: jax.image.resize 'linear' and F.interpolate agree, the
    # border rows and columns equal to the input's
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jins._upsample2x_bilinear(x))
    got = inspose.upsample2x_bilinear(t(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    close(got, want, rel=1e-6, what="bilinear x2")
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], atol=1e-6)

    # DeformConvGN: one folded call against 9 one-hot calls, offsets of a
    # few cells (some taps fall outside the map)
    B, h, w, C = 2, 6, 9, 64
    x = rng.randn(B, h, w, C).astype(np.float32)
    off = (rng.randn(B, h, w, 18) * 2.5).astype(np.float32)
    g = rng.randn(B, h, w, C).astype(np.float32)
    dcn = inspose.DeformConvGN(C, C)
    jdcn = jins.DeformConvGN(C)
    v = carried(dcn, jdcn, x, off)

    def jloss(params, x, off):
        y = jdcn.apply({"params": params}, x, off)
        return (y * g).sum(), y

    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, (0, 1, 2), has_aux=True))(v["params"], x, off)
    tx, toff = t(x).requires_grad_(), t(off).requires_grad_()
    y = dcn(tx.permute(0, 3, 1, 2), toff).permute(0, 2, 3, 1)
    (y * t(g)).sum().backward()
    close(y.detach().numpy(), want, what="deform conv")
    close(tx.grad.numpy(), grads[1], rel=1e-4, what="grad x")
    close(toff.grad.numpy(), grads[2], rel=1e-4, what="grad offsets")
    jgrads = jax_variables_to_state_dict({"params": grads[0]})
    for name, p in dcn.named_parameters():
        close(p.grad.numpy(), jgrads[name], rel=1e-4, what=name)


def test_soft_nms_varifocal_assign_and_heatmaps_match_jax():
    rng = np.random.RandomState(1)
    # soft-NMS over clustered boxes, so that many pairs overlap above 0.3
    xy = rng.uniform(0, 60, (3, 40, 2)) + rng.randint(0, 3, (3, 40, 1)) * 80
    boxes = np.concatenate([xy, xy + rng.uniform(10, 50, (3, 40, 2))],
                           -1).astype(np.float32)
    scores = rng.rand(3, 40).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(j_soft_nms))(boxes, scores))
    got = soft_nms_scores(t(boxes), t(scores)).numpy()
    assert (want < scores).sum() > 40          # the decay did act
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # bf16 scores: the port decays in float32 (JAX's bf16 InsPose cannot
    # serve: test_tiny_inspose_serving_matches_jax)
    assert soft_nms_scores(t(boxes), t(scores).bfloat16()).dtype == \
        torch.float32

    logits = (rng.randn(300, 1) * 2).astype(np.float32)
    target = np.where(rng.rand(300, 1) > 0.8, rng.rand(300, 1),
                      0).astype(np.float32)
    np.testing.assert_allclose(
        varifocal_loss(t(logits), t(target), avg_factor=7.0).item(),
        float(j_vfl(logits, target, avg_factor=7.0)), rtol=1e-6)

    det = inspose.InsPoseDetector(**TINY)
    jdet = jins.InsPoseDetector(**TINY)
    shapes = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))
    points = torch.cat([det.level_points(s, st)
                        for s, st in zip(shapes, det.strides)])
    strides = torch.cat([torch.full((s[0] * s[1],), float(st))
                         for s, st in zip(shapes, det.strides)])
    np.testing.assert_array_equal(points.numpy(), np.concatenate([
        jdet.level_points(s, st) for s, st in zip(shapes, det.strides)]))
    batch = pose_batch(seed=2, G=6)
    boxes, valid = batch["gt_boxes"], batch["gt_valid"]
    boxes[0, 3] = boxes[0, 0]              # a tie of areas: the first wins
    valid[0, 3] = True
    want = jax.jit(jax.vmap(lambda b, v: jins.InsPoseDetector._assign(
        jdet, jnp.asarray(points.numpy()), jnp.asarray(strides.numpy()), b,
        v)))(boxes, valid)
    got = det.assign(points, strides, t(boxes), t(valid))
    assert int(got[1].sum()) > 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    B, M, h0, w0 = 2, 5, 16, 24
    dyn = (rng.randn(B, M, 313) * 0.5).astype(np.float32)
    shared = rng.rand(B, h0, w0, 8).astype(np.float32)
    centers = rng.uniform(0, 190, (B, M, 2)).astype(np.float32)
    norm = rng.choice([64.0, 128.0, 256.0], (B, M)).astype(np.float32)
    for n in (None, norm):
        want = jax.jit(lambda *a: jins.InsPoseDetector.dynamic_heatmaps(
            jdet, *a, normalize=n))(dyn, shared, centers)
        got = det.dynamic_heatmaps(t(dyn), t(shared).permute(0, 3, 1, 2),
                                   t(centers), None if n is None else t(n))
        close(got.numpy(), np.asarray(want).reshape(B, M, h0 * w0, 17),
              what="dynamic heatmaps")


# ---------------------------------------------------------------- model
def jax_run(module, b):
    """Inside a JAX apply: the flattened level outputs, the shared map, the
    top-k and ``forward_test``."""
    outs, shared, _ = module.forward_levels(b["img"])
    cls, dyn, off, _, _ = module._flatten_levels(outs)
    scores, idx = jax.lax.top_k(jax.nn.sigmoid(cls)[..., 0],
                                module.max_per_img)
    return dict(cls=cls, dyn=dyn, off=off, shared=shared, scores=scores,
                idx=idx, det=module.forward_test(b))


@pytest.fixture(scope="module")
def tiny_inspose():
    batch = pose_batch()
    jmodel = jins.InsPoseDetector(**TINY)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=True), batch)
    model = inspose.InsPoseDetector(**TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)

    @jax.jit
    def run(v, b):
        def loss_fn(params):
            losses = jmodel.apply(dict(v, params=params), b, train=True)
            return losses["loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        return jmodel.apply(v, b, method=jax_run), losses, grads

    want, jlosses, jgrads = jax.device_get(run(variables, batch))
    tb = {k: t(v) for k, v in batch.items()}
    with torch.no_grad():
        outs, shared, _ = model.forward_levels(tb["img"], with_hm=False)
        cls, dyn, off, _, _ = model.flatten_levels(outs)
        got = dict(cls=cls, dyn=dyn, off=off, shared=shared.permute(
            0, 2, 3, 1))
    got = {k: v.numpy() for k, v in got.items()}
    got["own"] = {k: v.numpy() for k, v in model.forward_test(tb).items()}
    got["det"] = {k: v.numpy() for k, v in model.forward_test(
        tb, topk_idx=t(np.asarray(want["idx"])).long()).items()}
    losses = model.forward_train(tb)
    losses["loss"].backward()
    model64 = copy.deepcopy(model).double()
    model64.zero_grad(set_to_none=True)
    model64.forward_train({k: v.double() if v.is_floating_point() else v
                           for k, v in tb.items()})["loss"].backward()
    return dict(model=model, model64=model64, got=got, want=want,
                batch=batch, shapes=shapes,
                losses={k: v.item() for k, v in losses.items()},
                jlosses=jlosses,
                jgrads=jax_variables_to_state_dict({"params": jgrads}))


def test_tiny_inspose_serving_matches_jax(tiny_inspose):
    got, want = tiny_inspose["got"], tiny_inspose["want"]
    for k in ("cls", "dyn", "off", "shared"):
        close(got[k], want[k], what=k)
    jdet, det = want["det"], got["det"]
    assert det["det_kpts"].shape == (2, 6, 17, 3)
    np.testing.assert_allclose(det["det_kpts"][..., :2],
                               jdet["det_kpts"][..., :2], atol=1e-2)
    np.testing.assert_allclose(det["det_kpts"][..., 2],
                               jdet["det_kpts"][..., 2], atol=1e-4)
    np.testing.assert_allclose(det["det_bboxes"][..., :4],
                               jdet["det_bboxes"][..., :4], atol=1e-2)
    np.testing.assert_allclose(det["det_bboxes"][..., 4],
                               jdet["det_bboxes"][..., 4], atol=1e-5)
    np.testing.assert_array_equal(det["keep"], jdet["keep"])
    np.testing.assert_array_equal(det["det_labels"], jdet["det_labels"])
    # the port's own top-k: JAX's scores, so its selection is JAX's or a
    # tie; soft-NMS leaves every score at most its top-k score
    np.testing.assert_allclose(np.sort(got["own"]["det_bboxes"][..., 4]),
                               np.sort(det["det_bboxes"][..., 4]), atol=1e-5)
    assert (det["det_bboxes"][..., 4] <= want["scores"] + 1e-7).all()
    assert (det["det_bboxes"][..., 4] < want["scores"] - 1e-4).any()
    # JAX's soft-NMS loop carries the bf16 top-k scores and decays them by
    # float32 IoUs: its bf16 InsPose fails while tracing forward_test
    batch = tiny_inspose["batch"]
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda v: jins.InsPoseDetector(
            **TINY, dtype=jnp.bfloat16).apply(v, {
                k: batch[k] for k in ("img", "img_shape", "scale_factor")}),
            tiny_inspose["shapes"])


def test_tiny_inspose_losses_and_gradients_match_jax(tiny_inspose):
    """All 8 loss terms and every parameter's gradient: a missing detach
    (the star offsets' 0.9, the OKS target) shows here."""
    want, got = tiny_inspose["jlosses"], tiny_inspose["losses"]
    assert set(got) == set(want) == {
        "loss", "loss_cls", "loss_keypoint", "loss_keypoint_reg",
        "loss_heatmap", "loss_ae_pull", "loss_ae_push",
        "loss_heatmap_offset"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    model, jgrads = tiny_inspose["model"], tiny_inspose["jgrads"]
    labels = param_labels(model)
    assert set(jgrads) == set(labels)
    assert sum(v == "frozen" for v in labels.values()) > 10
    for m in (model, tiny_inspose["model64"]):
        for name, p in m.named_parameters():
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float().numpy()
            rel = (1e-3 if labels[name] == "frozen" and m is model
                   else 1e-4)
            close(g, jgrads[name], rel=rel, what=name)


# ---------------------------------------------------------- checkpoints
def tiny_configs():
    opts = {"model.backbone.depth": 18,
            "model.bbox_head.feat_channels": 64,
            "model.bbox_head.feat_channels_kpt": 64,
            "model.bbox_head.feat_channels_hm": 64,
            "model.bbox_head.stacked_convs": 1,
            "model.bbox_head.stacked_convs_kpt": 1,
            "model.bbox_head.stacked_convs_hm": 2,
            "model.test_cfg.max_per_img": 6}
    out = []
    for cls in (Config, JConfig):
        cfg = cls.fromfile(CONFIG)
        cfg.merge_from_dict(opts)
        out.append(cfg)
    return out


def test_inspose_reference_checkpoint_matches_jax_converter(tmp_path):
    cfg, jcfg = tiny_configs()
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    jmodel = jax_build_detector(jcfg.model)
    assert isinstance(model, inspose.InsPoseDetector)
    assert isinstance(jmodel, jins.InsPoseDetector)
    batch = pose_batch()
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=True), batch)
    V = port_weights_on_jax_tree(model, shapes)
    P = jax_variables_to_state_dict(V)
    rules, _ = reference_rules(model)
    assert {r.kind for r in rules} == {"copy", "dcn"}
    R = invert([r for r in rules if r.kind != "dcn"], P)
    for r in rules:
        if r.kind == "dcn":     # Linear (o, 9i) tap-major -> (o, i, 3, 3)
            w = P[r.ports[0]]
            R[r.refs[0]] = w.reshape(w.shape[0], 3, 3, -1).permute(
                0, 3, 1, 2).contiguous()

    # JAX's converter consumes all of R and gives back V, leaf for leaf
    out = jwc.convert_inspose_state_dict(
        {k: v.numpy() for k, v in R.items()}, stacked_convs=1,
        stacked_convs_kpt=1, stacked_convs_hm=2, backbone_depth=18,
        strict=True)
    assert out.pop("_unused_reference_keys") == []
    want, got = leaves(V), leaves(out)
    assert set(got) == set(want)
    assert all(np.array_equal(want[k], got[k]) for k in want)

    # the port's conversion of R equals P bit for bit, every key of the
    # model
    conv, unused = convert_reference_state_dict(model, R, strict=True)
    assert unused == [] and set(conv) == set(model.state_dict())
    assert all(torch.equal(conv[k], P[k]) for k in conv)

    # through init_detector, serving as the model built from P
    path = str(tmp_path / "inspose.pth")
    torch.save({"meta": {"epoch": 1}, "state_dict": {
        f"module.{k}" if i % 2 else k: v for i, (k, v) in enumerate(
            R.items())}}, path)
    assert set(load_torch_checkpoint(path)) == set(R)
    served = init_detector(cfg, device="cpu", checkpoint=path)
    assert all(torch.equal(v, P[k]) for k, v in served.state_dict().items())
    model.load_state_dict(P, strict=True)
    tb = {k: t(v) for k, v in batch.items() if not k.startswith("gt_")}
    with torch.no_grad():
        a = served.forward_test(tb)
        b = model.eval().forward_test(tb)
    assert all(torch.equal(a[k], b[k]) for k in a)

    # the trainer: the config's AdamW (lr 1e-4, weight decay 1e-4), clip
    # 0.1, 8 mini-steps an update; a train step on InsPose's keys
    state = init_trainer(cfg, device="cpu")
    assert (state.lr, state.grad_clip, state.accumulate_steps) == (
        1e-4, 0.1, 8)
    assert {g["weight_decay"] for g in state.optimizer.param_groups} == {
        1e-4}
    assert feed_keys(state.model) == INSPOSE_KEYS
    losses = train_step(state, pose_batch())
    assert len(losses) == 8 and all(torch.isfinite(v) for v in
                                    losses.values())

    # the full-width config's tree: names and shapes
    with torch.device("meta"):
        full = build_detector(Config.fromfile(CONFIG).model)
    rules, _ = reference_rules(full)
    assert sum(r.kind == "dcn" for r in rules) == 2
    own = full.state_dict()
    assert {p for r in rules for p in r.ports} == set(own)


def test_jax_train_cli_cannot_feed_inspose(tmp_path):
    """JAX's train CLI feeds ``ClipLoader`` batches to ``model.init`` and
    the train step: on COCO data the batch has a frame axis and
    ``gt_bboxes``, the JAX ``forward_train`` wants neither (a KeyError on
    ``gt_boxes`` once the frame axis is gone). The port's ``forward_train``
    names the missing key the same way."""
    from pavenet_tpu.datasets import coco_pose as jcoco_pose
    from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader
    from pavenet_tpu.datasets.pipelines import transforms as jtf
    from tests.test_torch_coco_data import write_family
    ann = write_family(tmp_path, 17)
    kwargs = Config.fromfile(os.path.join(
        REPO, "configs/videopose/pavenet_tiny_debug.py"))[
            "train_pipeline_kwargs"]
    loader = JClipLoader(jcoco_pose.CocoPoseDataset(
        ann_file=str(ann), img_prefix=str(tmp_path) + "/",
        pipeline=jtf.build_train_pipeline(**kwargs)), batch_size=2,
        max_gt=4, num_keypoints=17, shuffle=False)
    batch = dict(next(iter(loader)))
    assert "gt_bboxes" in batch and "gt_boxes" not in batch
    assert batch["img"].ndim == 5
    jmodel = jins.InsPoseDetector(**TINY)

    def init(b):
        return jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, b, train=True))

    feed = {k: v for k, v in batch.items() if not k.startswith("_")
            and k != "image_id"}
    with pytest.raises(Exception):
        init(feed)
    with pytest.raises(KeyError, match="gt_boxes"):
        init(dict(feed, img=feed["img"][:, 0].astype(np.float32)))
    model = inspose.InsPoseDetector(**TINY)
    tb = {k: t(np.asarray(v)) for k, v in feed.items()}
    tb["img"] = tb["img"][:, 0].float()
    with pytest.raises(KeyError, match="gt_boxes"):
        model.forward_train(tb)
