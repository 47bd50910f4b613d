"""The bf16 activation path: the port against the JAX package, both in
bfloat16 on the CPU.

The tiny model of ``tests/test_torch_trainable_bn.py`` (its weights, laid
onto the JAX tree and noised the same way) with ``norm_eval=False,
frozen_stages=1`` (frozen stem and ``layer1``, trainable norms after
them), ``dtype`` bfloat16 on both sides: flax's ``dtype=`` policy (f32
parameters cast per layer, norms' statistics in f32) against the port's
``models/layers/dtype.py``. JAX runs its msda through the XLA gather, which
forms the bilinear weights and sums in bf16; the port's plain msda sums in
f32 and returns bf16.

One JAX compile: a train-mode forward (trainable norms in train mode)
that returns the loss dict, the new running statistics and, through
``capture_intermediates``, the head's outputs; the joint decoder runs on
its own on the JAX side's best candidates, as serving runs it. Top-k
near-ties: bf16 proposal scores tie often (here the port's own top-k
takes JAX's proposals in another order, which pairs them with other query
embeddings), so the comparison goes stage by stage and gives the port the
JAX side's selection where it reaches past the top-k (``topk_idx``, the
head's hook). Every compared output has the JAX side's
dtype. The file keeps few test items (pytest-xdist's ``loadfile`` queue
takes files with more tests first; its JAX compile should not delay the
suite's longest files).

Tolerances: each stage's max abs error within 6e-2 of the JAX output's
largest value, about bf16's own error here: the encoder memory of either
side in bf16 is 3.4e-2 (JAX) and 4.4e-2 (port) of its largest from the f32
memory (serving; ``python tests/test_torch_bf16.py`` prints these), and
the two are 4.0e-2 apart; every other stage is
closer (observed: proposal scores 5.1e-3, decoder class scores 9.6e-3,
sigmas 6.1e-3, keypoints 4.4e-3 last layer and 1.1e-2 per frame, the
joint decoder's keypoints 4.9e-4 and scores 6.8e-3). The loss dict within
1e-2 relative (observed at most 1.5e-3; the class losses equal), the
trainable norms' new running statistics within 2e-2 of their scale
(observed 6.0e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu_torch.apis import build_model, init_detector
from pavenet_tpu_torch.apis.train import init_trainer, train_step
from pavenet_tpu_torch.models import VideoPoseDetector
from pavenet_tpu_torch.models.zoo import dummy_clip_batch
from pavenet_tpu_torch.utils.weight_convert import (
    batch_stats_to_numpy, jax_variables_to_state_dict)
from test_torch_trainable_bn import (REPO, TINY, jax_tree_shapes,
                                     leaves_by_port_name,
                                     port_weights_on_jax_tree, train_batch)

KW = dict(dropout=0.0, norm_eval=False, frozen_stages=1, **TINY)
STAGES = ("memory", "enc_cls_scores", "init_reference", "all_cls_scores",
          "all_kpt_preds", "all_sigma_preds", "frame_kpt_preds")
REFINE = ("refine_kpts", "refine_scores", "refine_sigmas")
TOL = 6e-2
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recording_top_k(store):
    """``jax.lax.top_k`` that also keeps its indices (traced: the caller
    returns them from the jitted function)."""
    real = jax.lax.top_k

    def top_k(x, k):
        values, idx = real(x, k)
        store.append(idx)
        return values, idx
    return top_k


def port_model(variables):
    model = VideoPoseDetector(dtype=torch.bfloat16, **KW)
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def runs():
    """Both sides on one batch: JAX's train-mode forward (losses, new
    statistics, the head's outputs, its top-k) and its joint decoder on
    its 5 best candidates of the last decoder layer; the port's train step
    given JAX's top-k, its head outputs in train mode given JAX's top-k
    and on its own, and its joint decoder on the same candidates."""
    batch = train_batch()
    init = VideoPoseDetector(**KW)
    init.init_weights(torch.Generator().manual_seed(0))
    jmodel = JDetector(max_gt=8, dtype=jnp.bfloat16, **KW)
    variables = port_weights_on_jax_tree(init,
                                         jax_tree_shapes(jmodel, batch))
    picked = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording_top_k(picked))

        @jax.jit
        def run(v, b):
            picked.clear()
            losses, state = jmodel.apply(
                v, b, train=True, capture_intermediates=True,
                mutable=["batch_stats", "intermediates"])
            head = state["intermediates"]["head"]["__call__"][0]
            return (losses, state["batch_stats"],
                    {k: head[k] for k in STAGES}, picked[0])

        want_losses, want_stats, want, idx = jax.device_get(
            run(variables, batch))
    idx = t(np.array(idx)).long()
    score = np.asarray(want["all_cls_scores"][-1][..., 0], np.float32)
    best = np.argsort(-score, axis=1, kind="stable")[:, :5]
    ref_poses = np.take_along_axis(
        np.asarray(want["frame_kpt_preds"], np.float32),
        best[:, None, :, None], 2).transpose(0, 2, 1, 3)

    model = port_model(variables).train()
    losses = model.forward_train({k: t(v) for k, v in batch.items()},
                                 topk_idx=idx)
    losses["loss"].backward()
    heads = port_model(variables)
    with torch.no_grad():
        own = heads.forward_outputs(t(batch["img"]), t(batch["img_shape"]),
                                    train=True)
        got = heads.forward_outputs(t(batch["img"]), t(batch["img_shape"]),
                                    train=True, topk_idx=idx)
        refined = heads.head.forward_refine(
            got["memory"], got["mask_flatten"], got["valid_ratios"],
            t(ref_poses), got["spatial_shapes"])
    shapes = got["spatial_shapes"]
    want.update(zip(REFINE, jax.device_get(jax.jit(
        lambda v, m, mask, vr, rp: jmodel.apply(
            v, m, mask, vr, rp, shapes, method=jmodel.refine_head))(
                variables, want["memory"], got["mask_flatten"].numpy(),
                got["valid_ratios"].numpy(), ref_poses))))
    outs = {k: got[k] for k in STAGES}
    outs.update(zip(REFINE, refined))
    return dict(variables=variables, want=want, got=outs, own=own,
                used=got["topk_idx"], given=idx, want_losses=want_losses,
                want_stats=want_stats, model=model,
                losses={k: v.item() for k, v in losses.items()})


def test_bf16_stages_and_topk_hook(runs):
    """Each stage's dtype is JAX's, and its max abs error is within
    ``TOL`` of the JAX output's largest value. With ``topk_idx`` the head
    takes and reports that selection; without it, the top-k of its own
    proposal scores (invalid positions at -1e4)."""
    errs = {}
    for key in STAGES + REFINE:
        want, got = runs["want"][key], runs["got"][key]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), key
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, key
        errs[key] = np.abs(got.float().numpy() - want).max() / np.abs(
            want).max()
    assert all(e <= TOL for e in errs.values()), errs

    own = runs["own"]
    assert torch.equal(runs["used"], runs["given"])
    scores = own["enc_cls_scores"][..., 0].float()
    picked = torch.gather(scores, 1, own["topk_idx"])
    rest = scores.scatter(1, own["topk_idx"], float("-inf"))
    assert (picked.amin(1) >= rest.amax(1)).all()


def test_bf16_train_step_matches_jax(runs):
    """The loss dict; the trainable norms' new statistics (f32, from bf16
    activations), the frozen stem and layer1 keeping theirs; gradients in
    f32 and finite."""
    want, got = runs["want_losses"], runs["losses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-2,
                                   err_msg=k)
    want = leaves_by_port_name(runs["want_stats"])
    got = leaves_by_port_name(batch_stats_to_numpy(runs["model"]))
    old = leaves_by_port_name(runs["variables"]["batch_stats"])
    assert set(got) == set(want)
    for k, b in want.items():
        np.testing.assert_allclose(got[k], b, atol=2e-2 * np.abs(b).max(),
                                   rtol=0, err_msg=k)
        frozen = k.startswith(("backbone.bn1.", "backbone.layer1_"))
        assert np.array_equal(got[k], old[k]) == frozen, k
    grads = [p.grad for p in runs["model"].parameters()
             if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(torch.isfinite(g).all() for g in grads)


# ----------------------------------------------------------------------
# the entry points' dtype argument
# ----------------------------------------------------------------------
def test_init_detector_and_trainer_take_a_dtype():
    """``dtype='bf16'`` (or the config's ``act_dtype``): activations in
    bf16, parameters and optimizer state in f32; the tiny config serves
    and takes a train step on the CPU."""
    cfg = f"{REPO}/configs/videopose/pavenet_tiny_debug.py"
    model = init_detector(cfg, device="cpu", dtype="bf16")
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    batch = dummy_clip_batch(np.random.RandomState(0), height=64, width=96)
    with torch.no_grad():
        out = model.forward_test({k: t(v) for k, v in batch.items()})
    assert torch.isfinite(out["det_kpts"]).all()
    assert build_model(cfg).dtype == torch.float32
    state = init_trainer(cfg, device="cpu", dtype="bfloat16")
    assert state.model.dtype == torch.bfloat16
    batch = dummy_clip_batch(np.random.RandomState(0), height=64, width=96,
                             max_gt=state.max_gt, train=True)
    losses = train_step(state, batch)
    assert torch.isfinite(losses["loss"])
    for _ in range(state.accumulate_steps - 1):
        train_step(state, batch)
    assert state.updates == 1
    assert all(v["exp_avg"].dtype == torch.float32
               for v in state.optimizer.state.values())


def bf16_error_report():
    """Each side's bf16 encoder memory and proposal scores against its own
    f32 ones, serving (eval mode), the weights of the tests above (not a
    test: four forward compiles). Run ``JAX_PLATFORMS=cpu python
    tests/test_torch_bf16.py``."""
    batch = train_batch()
    init = VideoPoseDetector(**KW)
    init.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(init, jax_tree_shapes(
        JDetector(max_gt=8, **KW), batch))
    keys = ("memory", "enc_cls_scores")
    outs = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jmodel = JDetector(max_gt=8, dtype=jdt, **KW)
        jout = jax.jit(lambda v, img, ish: {k: jmodel.apply(
            v, img, ish, method=jmodel.forward_outputs)[k] for k in keys})(
                variables, batch["img"], batch["img_shape"])
        model = VideoPoseDetector(dtype=tdt, **KW)
        model.load_state_dict(jax_variables_to_state_dict(variables))
        with torch.no_grad():
            pout = model.eval().forward_outputs(t(batch["img"]),
                                                t(batch["img_shape"]))
        outs["jax_" + name] = {k: np.asarray(jout[k], np.float32)
                               for k in keys}
        outs["port_" + name] = {k: pout[k].float().numpy() for k in keys}
    for k in keys:
        ref = outs["jax_f32"][k]
        scale = np.abs(ref).max()
        print(k, {side: float(np.abs(outs[side][k] - ref).max() / scale)
                  for side in ("port_f32", "jax_bf16", "port_bf16")},
              "bf16 sides apart:", float(np.abs(
                  outs["port_bf16"][k] - outs["jax_bf16"][k]).max() / scale))


if __name__ == "__main__":
    jax.config.update("jax_default_matmul_precision", "highest")  # conftest
    bf16_error_report()
