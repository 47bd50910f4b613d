"""The port's DK-DETR against the JAX package's on the CPU: SOIT with
cosine text-embedding classification and trainable BatchNorm.

The tiny SOIT of ``tests/test_torch_soit.py`` with ``cls_emb_dim=16``,
``temperature=0.05``, five classes with seeded text embeddings and
``norm_eval=False`` (the stem and ``layer1`` stay frozen, as in
``configs/dk-detr/dkd_r50_70e_lvis.py``), dropout 0, B=2 at 68x100. The
port runs in float32 against JAX in float64 (``jax.enable_x64``): with
BatchNorm in train mode JAX's own float32 gradients stray up to 2.65e-2 of
a tensor's largest (``tests/test_torch_trainable_bn.py``). One JAX compile
gives ``forward_test`` with five and with three text rows, the loss dict,
every gradient and the new running statistics; JAX's optax chain
(``optax_by_label``) then takes one AdamW step (lr 1e-3, weight decay 0.1,
backbone lr_mult 1.0, clip 0.1), the port's ``accumulate`` the same.

Tolerances (float32 against float64): boxes 1e-3 px, scores and mask
probabilities 1e-5, labels equal; losses rtol 1e-5; gradients 1e-3 of each
tensor's largest plus 1e-6; running statistics 1e-5 of their scale;
parameters after the step as in ``tests/test_torch_trainable_bn.py``.

JAX's ``forward_test`` decodes its flat top-k with ``num_classes``, not
the logits' class count (``pavenet_tpu/models/detectors/soit.py:567-568``):
with fewer text rows than ``num_classes`` (the DK-DETR transfer configs:
1203 against COCO's 80, Objects365's 365, VOC's 20) its labels leave the
class range. The port decodes with the logits' count; at equal counts the
two agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see tests/test_torch_trainable_bn.py)

from pavenet_tpu.models.detectors.soit import SOITDetector as JSOIT
from pavenet_tpu_torch.models.detectors.soit import SOITDetector
from pavenet_tpu_torch.utils.weight_convert import (
    batch_stats_to_numpy, jax_variables_to_state_dict)
from tests.test_torch_soit import TINY, check_detections, det_batch
from tests.test_torch_trainable_bn import (LR, f32_state_dict,
                                           leaves_by_port_name,
                                           optax_by_label,
                                           port_step as bn_port_step,
                                           port_weights_on_jax_tree)

DK = dict(TINY, cls_emb_dim=16, temperature=0.05, norm_eval=False)
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_selection(module, b):
    """JAX ``forward_test``'s flat top-k over queries x classes."""
    outs = module.forward_outputs(b["img"], b["img_shape"],
                                  text_feats=b["text_feats"])
    scores = jax.nn.sigmoid(outs["all_cls_scores"][-1])
    return jax.lax.top_k(scores.reshape(scores.shape[0], -1),
                         module.max_per_img)[1]


@pytest.fixture(scope="module")
def tiny_dkdetr():
    batch = det_batch(seed=1)
    rng = np.random.RandomState(3)
    batch["text_feats"] = rng.randn(5, 16).astype(np.float32)
    few = rng.randn(3, 16).astype(np.float32)
    shapes = jax.eval_shape(lambda b: JSOIT(**DK).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True), batch)
    model = SOITDetector(dropout=0.0, **DK)
    model.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(model, shapes)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)
    import flax.linen as fnn
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        jmodel = JSOIT(dtype=jnp.float64, **DK)
        v64 = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
        b64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
               for k, v in batch.items()}

        @jax.jit
        def run(params, stats, b, few):
            def loss_fn(p):
                out, mutated = jmodel.apply(
                    {"params": p, "batch_stats": stats}, b, train=True,
                    mutable=["batch_stats"])
                return out["loss"], (out, mutated["batch_stats"])
            (_, (losses, new_stats)), g = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            v = {"params": params, "batch_stats": stats}
            det = jmodel.apply(v, b, method=jmodel.forward_test)
            det["det_idx"] = jmodel.apply(v, b, method=jax_selection)
            det_few = jmodel.apply(v, dict(b, text_feats=few),
                                   method=jmodel.forward_test)
            return det, det_few, losses, g, new_stats

        jdet, jdet_few, jlosses, jgrads, jstats = jax.device_get(run(
            v64["params"], v64["batch_stats"], b64,
            few.astype(np.float64)))
        jparams = optax_by_label(v64["params"], jgrads, trainable_bn=True,
                                 frozen_stages=1)
    tb = {k: t(v) for k, v in batch.items()}
    model.eval()
    det = {k: v.numpy() for k, v in model.forward_test(
        tb, det_idx=t(jdet.pop("det_idx"))).items()}
    det_few = {k: v.numpy() for k, v in model.forward_test(
        dict(tb, text_feats=t(few))).items()}
    losses, grads = bn_port_step(model, batch)
    return dict(model=model, variables=variables, det=det, jdet=jdet,
                det_few=det_few, jdet_few=jdet_few,
                losses={k: v.item() for k, v in losses.items()},
                jlosses=jlosses, grads=grads, jgrads=f32_state_dict(jgrads),
                jparams=f32_state_dict(jparams), jstats=jstats)


def test_tiny_dkdetr_serving_matches_jax_and_decodes_in_range(tiny_dkdetr):
    """Five text rows (= ``num_classes``): the detections of both sides
    agree, the port given JAX's flat top-k (``det_idx``: the seeded
    embeddings score every pair near 1, where float32 scores of different
    pairs tie and float64 ones do not). Three rows: the same scores (the
    flat top-k is right on both sides), the port's labels below 3, JAX's
    out of range."""
    check_detections(tiny_dkdetr["det"], tiny_dkdetr["jdet"])
    got, want = tiny_dkdetr["det_few"], tiny_dkdetr["jdet_few"]
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    assert got["det_labels"].max() < 3
    assert want["det_labels"].max() >= 3


def test_tiny_dkdetr_train_step_matches_jax(tiny_dkdetr):
    """The loss dict, every gradient, the parameters after one AdamW step
    (the no-decay ``backbone_norm`` group included) and every trainable
    BatchNorm's running statistics; the frozen stem and ``layer1`` keep
    theirs."""
    want, got = tiny_dkdetr["jlosses"], tiny_dkdetr["losses"]
    assert set(got) == set(want) and "loss_mask_dice" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    want, got = tiny_dkdetr["jgrads"], tiny_dkdetr["grads"]
    assert set(want) == set(got)
    for name, g in got.items():
        w = want[name]
        # + 1e-6: the key biases' gradient is 0 in exact arithmetic (the
        # softmax ignores a shift), float32 rounding leaves 1.3e-7 at this
        # loss's scale (285)
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max() + 1e-6,
                                   rtol=0, err_msg=name)
    jgrads = tiny_dkdetr["jgrads"]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in jgrads.values()))
    clip = min(1.0, 0.1 / norm)
    for name, p in tiny_dkdetr["model"].named_parameters():
        g = np.abs(jgrads[name])
        sure = (g > 1e-3 * g.max()) & (g * clip > 1e-6)
        tol = np.where(sure, 1e-6, 2 * LR)
        err = np.abs(p.detach().numpy() - tiny_dkdetr["jparams"][name])
        assert (err <= tol).all(), name
    want = leaves_by_port_name(tiny_dkdetr["jstats"])
    old = leaves_by_port_name(tiny_dkdetr["variables"]["batch_stats"])
    got = leaves_by_port_name(batch_stats_to_numpy(tiny_dkdetr["model"]))
    assert set(got) == set(want)
    moved = 0
    for k, b in want.items():
        np.testing.assert_allclose(got[k], b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0, err_msg=k)
        frozen = k.startswith(("backbone.bn1.", "backbone.layer1_"))
        assert np.array_equal(b, old[k]) == frozen, k
        moved += not frozen
    assert moved > 0
