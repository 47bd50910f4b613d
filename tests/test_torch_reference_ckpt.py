"""Reference ``.pth`` checkpoints: the port's rule table
(``utils/reference_convert.py``) against the JAX package's converters
(``pavenet_tpu/utils/weight_convert.py``), on the CPU.

For a tiny PAVE-Net (R18, T=3, the tiny debug config), a tiny PETR, a
tiny SOIT and a tiny DK-DETR (each config's R18, one encoder layer, two
decoder layers, 12 queries), V is the port's seeded init laid onto
``jax.eval_shape`` of the JAX train-mode init and noised, and P its
``jax_variables_to_state_dict``. R, the reference-named state dict, is
built from P by inverting the port's table; the keys that the JAX video
converter reads and the tiny PAVE-Net lacks (``bbox_head.fc_hm``) hold
seeded values. Then:

- JAX's ``convert_*_state_dict(R, strict=True)`` consumes every key of R
  and gives back V leaf for leaf, exactly (PETR with
  ``init_params=V['params']``); its only extra subtree is the video
  tree's ``fc_hm``;
- the port's conversion of R equals P bit for bit, strictly (PETR lacks
  the sigma branches, which keep the model's init);
- R saved as a ``.pth`` loads through ``init_detector(config,
  checkpoint=...)`` and serves as JAX serves V: keypoints within 1e-2 px,
  boxes within 1e-3, scores and masks within 1e-5 (the slice tests'
  limits); DK-DETR's raw class scores and boxes within 1e-5, since its
  seeded cosine scores tie in float32 near 1 and the top-k order among
  ties is no fault (``tests/test_torch_dkdetr.py``).

The full-width flagship, PETR R50 and SOIT R50 take names and shapes
only: R of zero-stride arrays through JAX's converter gives the tree of
``jax.eval_shape``, and R on the meta device through the port's table
loads into the meta model. A video Swin tree, which JAX's
``torch2flax.py`` refuses, the port refuses too.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu.utils import weight_convert as jwc
from pavenet_tpu_torch.apis.inference import init_detector
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import build_detector
from pavenet_tpu_torch.utils.reference_convert import (
    convert_reference_state_dict, keeps_own_init, load_reference_state_dict,
    load_torch_checkpoint, reference_rules)
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_soit import det_batch
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t = torch.from_numpy
ENC = "model.bbox_head.transformer.encoder"
TINY_OPTS = {"model.backbone.depth": 18, "model.bbox_head.num_query": 12,
             f"{ENC}.num_layers": 1,
             f"{ENC}.transformerlayers.attn_cfgs.embed_dims": 64,
             f"{ENC}.transformerlayers.feedforward_channels": 128,
             "model.bbox_head.transformer.decoder.num_layers": 2,
             "model.test_cfg.max_per_img": 5}
# family: (config, its own options, the JAX converter's layer arguments)
FAMILIES = {
    "pavenet": ("configs/videopose/pavenet_tiny_debug.py", {}),
    "petr": ("configs/petr/petr_r50_16x2_100e_coco.py",
             {"model.bbox_head.transformer.refine_decoder.num_layers": 1}),
    "soit": ("configs/soit/soit_r50_16x2_50e_coco.py",
             {"model.bbox_head.num_classes": 5}),
    "dkdetr": ("configs/dk-detr/dkd_r50_70e_lvis.py",
               {"model.bbox_head.num_classes": 5,
                "model.text_encoder.text_dim": 16}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(family):
    """The family's tiny config for the port and for JAX."""
    path, own = FAMILIES[family]
    opts = dict(TINY_OPTS, **own)
    if family == "pavenet":      # the tiny debug config is tiny already
        opts = {"model.bbox_head.num_query": 12}
    out = []
    for cls in (Config, JConfig):
        cfg = cls.fromfile(os.path.join(REPO, path))
        cfg.merge_from_dict(opts)
        out.append(cfg)
    return out


def family_batch(family, model):
    """A train-mode batch of the family (B=1 for the pose models, B=2 of
    ``tests/test_torch_soit.py``'s detection batch), DK-DETR's five text
    embeddings beside it."""
    if family in ("soit", "dkdetr"):
        batch = det_batch(num_classes=5)
        if family == "dkdetr":
            batch["text_feats"] = np.random.RandomState(3).randn(
                5, 16).astype(np.float32)
        return batch
    return j_dummy_clip_batch(
        np.random.RandomState(1), num_frames=model.num_frames, height=64,
        width=96, num_keypoints=model.num_keypoints, max_gt=4, train=True)


def invert(rules, P, seed=0):
    """The reference state dict that ``rules`` turn into ``P``; a rule's
    port keys that ``P`` lacks get seeded values (of the shape of the
    model's own ``fc_hm``: K rows over the embedding)."""
    rng = np.random.RandomState(seed)
    R = {}
    for rule in rules:
        vals = []
        for p in rule.ports:
            if p in P:
                vals.append(P[p])
            else:
                assert p.startswith("head.fc_hm."), p
                K, C = P["head.refine_query_embedding"].shape
                shape = (K, C // 2) if p.endswith("weight") else (K,)
                vals.append(t(rng.randn(*shape).astype(np.float32)))
        if rule.kind == "copy":
            R[rule.refs[0]] = vals[0]
        elif rule.kind == "cat":
            R.update(zip(rule.refs, vals[0].chunk(len(rule.refs), 0)))
        elif rule.kind == "split":
            R[rule.refs[0]] = torch.cat(vals, 0)
        else:                       # perm
            perm, axis = rule.arg
            out = torch.empty_like(vals[0])
            out.index_copy_(axis, torch.as_tensor(perm), vals[0])
            R[rule.refs[0]] = out
    return {k: v.contiguous() for k, v in R.items()}


def jax_convert(family, model, R, init_params=None):
    """JAX's converter for ``family`` on the numpy ``R``, strict."""
    layers = dict(num_encoder_layers=model.head.num_encoder_layers
                  if family in ("pavenet", "petr")
                  else model.num_encoder_layers,
                  num_decoder_layers=model.head.num_decoder_layers
                  if family in ("pavenet", "petr")
                  else model.num_decoder_layers,
                  backbone_depth=model.backbone.depth)
    if family == "pavenet":
        return jwc.convert_videopose_state_dict(
            R, num_frames=model.num_frames,
            num_refine_layers=model.head.num_refine_layers, strict=True,
            **layers)
    if family == "petr":
        return jwc.convert_petr_state_dict(
            R, init_params, num_refine_layers=model.head.num_refine_layers,
            strict=True, **layers)
    return jwc.convert_soit_state_dict(R, strict=True, **layers)


def leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_serve(family, jmodel, V, batch):
    """JAX's serving outputs on ``V`` (DK-DETR: the last decoder layer's
    class scores and boxes, before the top-k)."""
    if family == "dkdetr":
        def outs(module, b):
            o = module.forward_outputs(b["img"], b["img_shape"],
                                       text_feats=b["text_feats"])
            return {k: o[k][-1] for k in ("all_cls_scores",
                                          "all_bbox_preds")}
        fn = jax.jit(lambda v, b: jmodel.apply(v, b, method=outs))
    else:
        fn = jax.jit(lambda v, b: jmodel.apply(v, b,
                                               method=jmodel.forward_test))
    return jax.device_get(fn(V, batch))


def port_serve(family, model, batch):
    tb = {k: t(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        if family == "dkdetr":
            o = model.forward_outputs(tb["img"], tb["img_shape"],
                                      text_feats=tb["text_feats"])
            return {k: o[k][-1].numpy() for k in ("all_cls_scores",
                                                  "all_bbox_preds")}
        return {k: v.numpy() for k, v in model.forward_test(tb).items()}


def check_serving(family, got, want):
    if family == "dkdetr":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
        return
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    if family == "soit":
        np.testing.assert_array_equal(got["det_labels"], want["det_labels"])
        np.testing.assert_allclose(got["det_bboxes"][..., :4],
                                   want["det_bboxes"][..., :4], atol=1e-3)
        np.testing.assert_allclose(got["det_masks"], want["det_masks"],
                                   atol=1e-5)
        return
    np.testing.assert_allclose(got["det_kpts"], want["det_kpts"], atol=1e-2)
    np.testing.assert_array_equal(got["keep"], want["keep"])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_checkpoint_matches_jax_converter(family, tmp_path):
    cfg, jcfg = configs(family)
    model = build_detector(cfg.model)
    model.init_weights(torch.Generator().manual_seed(0))
    jmodel = jax_build_detector(jcfg.model)
    batch = family_batch(family, model)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)
    V = port_weights_on_jax_tree(model, shapes)
    P = jax_variables_to_state_dict(V)
    rules, _ = reference_rules(model)
    R = invert(rules, P)

    # JAX's converter consumes all of R and gives back V, leaf for leaf
    out = jax_convert(family, model, {k: v.numpy() for k, v in R.items()},
                      V["params"])
    assert out.pop("_unused_reference_keys") == []
    want, got = leaves(V), leaves(out)
    assert all(np.array_equal(want[k], got[k]) for k in want), family
    assert {k.split("]")[2] for k in set(got) - set(want)} <= {"['fc_hm'"}
    assert (set(got) > set(want)) == (family == "pavenet")

    # the port's conversion of R equals P bit for bit
    conv, unused = convert_reference_state_dict(model, R, strict=True)
    assert unused == []
    own = model.state_dict()
    assert all(torch.equal(conv[k], P[k]) for k in conv if k in own)
    lacking = set(own) - set(conv)
    assert bool(lacking) == keeps_own_init(model) == (family == "petr")
    assert all(".sigma_branch" in f".{k}" or "refine_sigma_branch" in k
               for k in lacking), sorted(lacking)[:5]

    # through init_detector, and serving as JAX serves V
    path = str(tmp_path / f"{family}.pth")
    torch.save({"meta": {"epoch": 1}, "state_dict": {
        f"module.{k}" if i % 2 else k: v
        for i, (k, v) in enumerate(R.items())}}, path)
    assert set(load_torch_checkpoint(path)) == set(R)
    served = init_detector(cfg, device="cpu", checkpoint=path)
    loaded = served.state_dict()
    for k, v in loaded.items():
        assert torch.equal(v, P[k] if k in conv else own[k]), k
    want = jax_serve(family, jmodel, V, {k: v for k, v in batch.items()
                                         if not k.startswith("gt_")})
    check_serving(family, port_serve(family, served, batch), want)


def test_full_width_trees_and_the_refusal():
    for config in ("configs/videopose/pavenet_r50_frames3_posetrack17.py",
                   "configs/petr/petr_r50_16x2_100e_coco.py",
                   "configs/soit/soit_r50_16x2_50e_coco.py"):
        path = os.path.join(REPO, config)
        family = ("soit" if "soit" in config
                  else "petr" if "petr" in config else "pavenet")
        with torch.device("meta"):
            model = build_detector(Config.fromfile(path).model)
        jmodel = jax_build_detector(JConfig.fromfile(path).model)
        if family == "soit":
            batch = det_batch(H=128, W=192, num_classes=80)
        else:
            # 128x192: 510 tokens, enough for the 300 queries' top-k
            batch = j_dummy_clip_batch(
                np.random.RandomState(0), height=128, width=192,
                num_frames=model.num_frames,
                num_keypoints=model.num_keypoints, max_gt=4, train=True)
        tree = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, b, train=True), batch)
        rules, _ = reference_rules(model)
        own = model.state_dict()
        ref_shapes = {}
        for rule in rules:
            shapes = [tuple(own[p].shape) if p in own else None
                      for p in rule.ports]
            if rule.kind == "cat":
                (s,), n = shapes, len(rule.refs)
                ref_shapes.update({k: (s[0] // n,) + s[1:]
                                   for k in rule.refs})
            elif rule.kind == "split":
                ref_shapes[rule.refs[0]] = (3 * shapes[0][0],) + shapes[0][1:]
            elif shapes[0] is not None:
                ref_shapes[rule.refs[0]] = shapes[0]
            else:                    # fc_hm: K rows over the embedding
                K, C = own["head.refine_query_embedding"].shape
                ref_shapes[rule.refs[0]] = ((K, C // 2) if rule.refs[0]
                                            .endswith("weight") else (K,))
        zeros = {k: np.lib.stride_tricks.as_strided(
            np.zeros(1, np.float32), s, (0,) * len(s))
            for k, s in ref_shapes.items()}
        out = jax_convert(family, model, zeros, tree["params"])
        assert out.pop("_unused_reference_keys") == []
        want = {k: tuple(v.shape) for k, v in leaves(tree).items()}
        got = {k: tuple(np.shape(v)) for k, v in leaves(out).items()}
        assert {k: got[k] for k in want} == want, config
        meta = {k: torch.empty(s, device="meta")
                for k, s in ref_shapes.items()}
        assert load_reference_state_dict(model, meta, strict=True) == []

    # JAX's torch2flax refuses a video tree with a Swin backbone; so does
    # the port
    path = os.path.join(REPO,
                        "configs/videopose/pavenet_swin_frames3_posetrack18.py")
    spec = importlib.util.spec_from_file_location(
        "torch2flax", os.path.join(REPO,
                                   "tools/dataset_converters/torch2flax.py"))
    torch2flax = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch2flax)
    with pytest.raises(SystemExit, match="ResNet trees"):
        torch2flax.convert(jax_build_detector(JConfig.fromfile(path).model),
                           {})
    with torch.device("meta"):
        swin = build_detector(Config.fromfile(path).model)
    with pytest.raises(ValueError, match="ResNet trees"):
        reference_rules(swin)
