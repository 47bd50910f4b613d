"""The port's windowed-encoder variant against the JAX package, f32 on the
CPU: window partition, the encoder layer (output and every gradient), the
tiny windowed model's serving and train step, the builder, and the encoder
distillation step.

The JAX side is initialised, noised leaf by leaf with seeded numpy and
converted (``jax_variables_to_state_dict``, ``strict=True``); both sides run
the same numpy inputs. The JAX windowed layers run their XLA partition path
on the CPU (the head passes them no ``impl``), the plain reference of the
Pallas kernel; the port runs ``window_attention_torch`` through its raster
path. Tolerances: the layer at 2e-5 (output) and 3e-4 (gradients), as the
JAX package's own kernel test; the model as ``tests/test_torch_videopose.py``
and ``tests/test_torch_train.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# loaded while the file is collected: see tests/test_torch_trainable_bn.py
import torch._dynamo  # noqa: F401

from pavenet_tpu.apis import distill as jdistill
from pavenet_tpu.apis.distill import make_distill_step
from pavenet_tpu.apis.train import TrainState as JTrainState
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu.models.layers import windowed as jwin
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu_torch.apis import distill as tdistill
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import (VideoPoseDetector, build_detector,
                                      pavenet_r50_frames3)
from pavenet_tpu_torch.models.layers import windowed as twin
from pavenet_tpu_torch.utils.weight_convert import (
    jax_variables_to_state_dict, load_jax_variables)
from tests.test_torch_videopose import run_without_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_frames=3, num_keypoints=15, num_query=12, backbone_depth=18,
            embed_dims=64, num_encoder_layers=2, num_decoder_layers=2,
            num_refine_layers=1, max_per_img=5, dropout=0.0)
HW = (96, 160)       # levels (12, 20), (6, 10), (3, 5), (2, 3)
SHAPES = ((9, 17), (5, 7))            # the JAX kernel test's levels
t = torch.from_numpy


def noised(variables, seed=0, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(
            np.float32), jax.device_get(variables))


# ----------------------------------------------------------------------
# window partition and the encoder layer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("hw", [(9, 17), (8, 16), (3, 5), (1, 2)])
def test_window_partition_roundtrip(hw, shift):
    Hl, Wl = hw
    x = np.random.RandomState(0).randn(2, Hl * Wl, 5).astype(np.float32)
    w = twin.window_partition(t(x), Hl, Wl, shift=shift)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jwin.window_partition(x, Hl, Wl, shift=shift)))
    back = twin.window_unpartition(w, 2, Hl, Wl, shift=shift)
    np.testing.assert_array_equal(back.numpy(), x)


def _layer_inputs(C=32, B=2, masked=True, seed=0):
    rng = np.random.RandomState(seed)
    n = sum(h * w for h, w in SHAPES)
    x = rng.randn(B, n, C).astype(np.float32)
    pos = rng.randn(B, n, C).astype(np.float32)
    if not masked:
        return x, pos, None
    mask = np.zeros((B, n), bool)
    start = 0
    for Hl, Wl in SHAPES:                    # right/bottom bucket padding
        m2 = np.zeros((Hl, Wl), bool)
        m2[:, -3:] = True
        m2[-2:, :] = True
        mask[:, start:start + Hl * Wl] = m2.reshape(-1)
        start += Hl * Wl
    return x, pos, mask


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layer_matches_jax(shift, masked):
    kw = dict(embed_dims=32, num_heads=4, feedforward_channels=64,
              dropout=0.0, shift=shift)
    jlayer = jwin.WindowedEncoderLayer(impl="xla", **kw)
    x, pos, mask = _layer_inputs(masked=masked)
    variables = noised(jax.jit(lambda: jlayer.init(
        jax.random.PRNGKey(0), x, pos, None, SHAPES, mask))())

    def loss(xx, params):
        out = jlayer.apply({"params": params}, xx, pos, None, SHAPES, mask)
        return jnp.sum(out * out), out

    (_, want), (gx, gp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(x, variables["params"])

    layer = twin.WindowedEncoderLayer(impl="torch", **kw)
    layer.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tx = t(x).requires_grad_()
    got = layer(tx, t(pos), None, SHAPES, None if mask is None else t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    (got * got).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=3e-4,
                               rtol=1e-4)
    want_grads = jax_variables_to_state_dict({"params": gp})
    params = dict(layer.named_parameters())
    assert set(want_grads) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name],
                                   atol=3e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("shift", [False, True])
def test_encoder_layer_attends_all_levels_in_one_call(shift, monkeypatch):
    """One window-attention call per layer over the padded level rasters
    (one kernel launch each way on the card), equal to one call per
    level."""
    calls = []
    real = twin.window_attention_levels

    def spy(qs, *args, **kw):
        calls.append([tuple(q.shape) for q in qs])
        return real(qs, *args, **kw)

    monkeypatch.setattr(twin, "window_attention_levels", spy)
    layer = twin.WindowedEncoderLayer(embed_dims=32, num_heads=4,
                                      feedforward_channels=64, dropout=0.0,
                                      shift=shift, impl="torch")
    x, pos, mask = _layer_inputs()
    layer(t(x), t(pos), None, SHAPES, t(mask))
    assert calls == [[(2, 16, 32, 32), (2, 8, 16, 32)]]

    q, k, v = (t(a) for a in np.random.RandomState(1).randn(3, *x.shape)
               .astype(np.float32))
    got = twin._attend_levels(q, k, v, t(mask), SHAPES, 4, shift=shift)
    per_level, start = [], 0
    for Hl, Wl in SHAPES:
        sl = slice(start, start + Hl * Wl)
        per_level.append(twin._attend_levels(
            q[:, sl], k[:, sl], v[:, sl], t(mask)[:, sl], [(Hl, Wl)], 4,
            shift=shift))
        start += Hl * Wl
    torch.testing.assert_close(got, torch.cat(per_level, 1), rtol=0, atol=0)


# ----------------------------------------------------------------------
# the tiny windowed model: serving and one train step
# ----------------------------------------------------------------------
def train_batch():
    return j_dummy_clip_batch(np.random.RandomState(1), batch_size=2,
                              height=HW[0], width=HW[1], max_gt=8, train=True)


@pytest.fixture(scope="module")
def jax_side():
    model = JDetector(max_gt=8, encoder_mode="windowed", **TINY)
    batch = train_batch()
    # noise seed 1: with seed 0 only the gradients of the pose decoder's
    # first layer differ, by up to 6% of their largest value (dec_ffn0), as
    # when a discrete choice there (a ReLU, the top-k) falls between two
    # f32 roundings; with seeds 1 and 2 every gradient agrees
    variables = noised(jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True))(batch), seed=1)

    def loss_fn(params):
        losses = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             batch, train=True)
        return losses["loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    serve = {k: v for k, v in batch.items() if not k.startswith("gt_")}
    det = jax.jit(lambda v, b: model.apply(v, b))(variables, serve)
    return (variables, batch, jax.tree.map(np.asarray, losses),
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, det))


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = VideoPoseDetector(encoder_mode="windowed", impl="torch", **TINY)
    model.load_state_dict(jax_variables_to_state_dict(jax_side[0]),
                          strict=True)
    return model


def test_serving_matches_jax(jax_side, port_model):
    batch = {k: t(v) for k, v in jax_side[1].items()
             if not k.startswith("gt_")}
    with torch.no_grad():
        det = port_model.eval().forward_test(batch)
    want = jax_side[4]
    assert det["det_kpts"].shape == (2, 5, 15, 3)
    np.testing.assert_allclose(det["det_kpts"].numpy(), want["det_kpts"],
                               atol=1e-2)
    np.testing.assert_array_equal(det["keep"].numpy(), want["keep"])


def test_train_step_matches_jax(jax_side, port_model):
    model = port_model.train()
    model.zero_grad(set_to_none=True)
    losses = model.forward_train({k: t(v) for k, v in jax_side[1].items()})
    losses["loss"].backward()
    want = jax_side[2]
    assert set(losses) == set(want)
    for k in want:
        np.testing.assert_allclose(losses[k].item(), want[k], rtol=1e-4,
                                   err_msg=k)
    want = jax_variables_to_state_dict({"params": jax_side[3]})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    model.zero_grad(set_to_none=True)


def test_builder_maps_windowed_config_to_zoo_model():
    cfg = Config.fromfile(os.path.join(
        REPO, "configs/videopose/pavenet_r50_frames3_posetrack17_windowed.py"))
    model = build_detector(cfg.model)
    assert type(model.head.encoder_layer5).__name__ == "WindowedEncoderLayer"
    assert [model.head._m("encoder_layer{}", i).shift for i in range(6)] == [
        False, True] * 3
    built = {k: v.shape for k, v in model.state_dict().items()}
    zoo = pavenet_r50_frames3(encoder_mode="windowed").state_dict()
    assert built == {k: v.shape for k, v in zoo.items()}
    assert "head.encoder_layer0.q_proj.weight" in built


# ----------------------------------------------------------------------
# encoder distillation
# ----------------------------------------------------------------------
def test_student_from_teacher_copies_and_rejects_mismatch():
    teacher = VideoPoseDetector(**TINY)
    student = VideoPoseDetector(encoder_mode="windowed", **TINY)
    teacher.init_weights(torch.Generator().manual_seed(1))
    student.init_weights(torch.Generator().manual_seed(2))
    t_sd, s_sd = teacher.state_dict(), student.state_dict()
    merged = tdistill.student_from_teacher(s_sd, t_sd)
    assert set(merged) == set(s_sd)
    shared = [k for k in merged if not k.startswith("head.encoder_layer")]
    assert len(shared) > 300
    for k in merged:
        want = s_sd[k] if k.startswith("head.encoder_layer") else t_sd[k]
        assert torch.equal(merged[k], want), k
        if k in t_sd:
            assert merged[k].data_ptr() != t_sd[k].data_ptr(), k
    with pytest.raises(KeyError, match="extra"):
        tdistill.student_from_teacher({"head.extra": torch.zeros(3)}, t_sd)
    bad = dict(t_sd, **{"head.level_embeds": torch.zeros(3, 64)})
    with pytest.raises(ValueError, match="level_embeds"):
        tdistill.student_from_teacher(s_sd, bad)


def test_distill_step_matches_jax(jax_side):
    """One step of ``make_distill_step`` (lr 1e-3, clip 0.1) and of the
    port's ``distill_step`` from the same teacher and student (the noised
    windowed model above, its shared parameters replaced by the teacher's).
    The JAX student keeps its own batch statistics; the port's copies the
    teacher's, so the JAX student gets the teacher's here.

    Adam's first step moves each parameter by about lr * g / (|g| + eps):
    where the clipped gradient g is near eps (1e-8) that quotient magnifies
    rounding (2.4e-5 = 2.4% of lr observed), so the updated encoder
    parameters are compared at 1e-6 where the port's clipped gradient
    exceeds 1e-6, and the step is held to move every encoder tensor."""
    teacher = JDetector(max_gt=8, **TINY)
    student = JDetector(max_gt=8, encoder_mode="windowed", **TINY)
    batch = jax_side[1]
    serve = {k: v for k, v in batch.items() if not k.startswith("gt_")}
    t_vars = noised(jax.jit(lambda b: teacher.init(
        jax.random.PRNGKey(0), b, train=False))(serve))
    # a serving init has no RLE flows; the teacher takes the student's
    flows = {k: v for k, v in jax_side[0]["params"]["head"].items()
             if k.endswith("flow")}
    t_vars["params"]["head"] = dict(t_vars["params"]["head"], **flows)
    s_params = jdistill.student_from_teacher(jax_side[0]["params"],
                                             t_vars["params"])
    tx = jdistill.encoder_only_optimizer(s_params, learning_rate=1e-3)
    s_state = JTrainState(step=jnp.zeros((), jnp.int32), params=s_params,
                          batch_stats=t_vars["batch_stats"],
                          opt_state=tx.init(s_params),
                          rng=jax.random.PRNGKey(2))
    new_state, logs = make_distill_step(student, teacher, tx)(
        s_state, t_vars, serve)
    want = jax_variables_to_state_dict(
        {"params": jax.device_get(new_state.params)})

    t_model = VideoPoseDetector(**TINY)
    load_jax_variables(t_model, t_vars)
    s_model = VideoPoseDetector(encoder_mode="windowed", impl="torch",
                                **TINY)
    load_jax_variables(s_model, jax_side[0])
    state = tdistill.create_distill_state(s_model, t_model,
                                          learning_rate=1e-3)
    before = {k: v.clone() for k, v in state.student.state_dict().items()}
    serve = {k: t(v) for k, v in serve.items()}
    # the port's gradient, clipped, to find where the update is well posed
    with torch.no_grad():
        target = t_model.forward_memory(serve["img"], serve["img_shape"])
    mse, _ = tdistill.memory_distill_loss(
        state.student.eval().forward_memory(serve["img"], serve["img_shape"])[
            "memory"], target["memory"], target["mask_flatten"])
    mse.backward()
    grads = {n: p.grad.clone() for n, p in state.student.named_parameters()
             if p.grad is not None}
    norm = torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads.values()])).item()
    state.student.zero_grad(set_to_none=True)

    got = tdistill.distill_step(state, serve)
    for k in ("distill_mse", "distill_rel"):
        np.testing.assert_allclose(got[k].item(), float(logs[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["grad_norm"].item(), norm, rtol=1e-5)
    assert norm > 0.1 and any(
        k.startswith("backbone") for k in grads)     # clipped, over all
    t_sd = t_model.state_dict()
    compared = total = 0
    for name, p in state.student.state_dict().items():
        if not name.startswith("head.encoder_layer"):
            assert torch.equal(p, t_sd[name]), name
            continue
        if name in grads:
            assert not torch.equal(p, before[name]), name
            well = (grads[name].abs() * (0.1 / norm) > 1e-6).numpy()
            np.testing.assert_allclose(p.numpy()[well], want[name][well],
                                       atol=1e-6, rtol=0, err_msg=name)
            compared += well.sum()
            total += well.size
    assert compared > 0.9 * total, (compared, total)


def test_windowed_slice_runs_without_jax():
    """The tiny windowed config's serving, one train step and one distill
    step, run alone, load neither jax nor flax nor the JAX package."""
    assert run_without_jax("""
        import sys
        import numpy as np
        from pavenet_tpu_torch.apis import (build_model, create_distill_state,
                                            distill_step, inference_detector,
                                            init_detector, init_trainer,
                                            train_step)
        from pavenet_tpu_torch.models.zoo import dummy_clip_batch
        cfg = "configs/videopose/pavenet_tiny_debug_windowed.py"
        rng = np.random.RandomState(0)
        model = init_detector(cfg, device="cpu", seed=0)
        clip = [rng.randint(0, 256, (90, 150, 3)).astype(np.uint8)
                for _ in range(3)]
        out = inference_detector(model, clip, img_scale=(160, 96))
        assert out["det_kpts"].shape == (5, 15, 3), out["det_kpts"].shape
        assert np.isfinite(out["det_kpts"]).all()
        state = init_trainer(cfg, device="cpu", seed=0)
        losses = train_step(state, dummy_clip_batch(
            rng, height=96, width=128, max_gt=state.max_gt, train=True))
        assert all(np.isfinite(float(v)) for v in losses.values())
        teacher = build_model("configs/videopose/pavenet_tiny_debug.py",
                              seed=1)
        ds = create_distill_state(cfg, teacher, seed=2)
        logs = distill_step(ds, dummy_clip_batch(rng, height=96, width=128))
        assert np.isfinite(float(logs["distill_mse"])), logs
    """) == "[]"
