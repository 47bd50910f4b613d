"""The port's train step against the JAX package's, f32 on the CPU.

Losses, flows, matching costs, the assignment, targets, the
``forward_train`` loss dict, every parameter's gradient, one optimizer
update and the lr schedules. The slice runs the tiny model of
``tests/test_torch_videopose.py`` (B=2, 64x96, 8 GT slots of which 2 are
valid) with dropout 0: the JAX side is initialised in train mode (so the
flows exist), noised leaf by leaf with seeded numpy and converted; both
sides run the same numpy batch. The JAX side runs its msda through
``ms_deform_attn_xla`` and its custom VJP, the plain reference of the
Pallas kernels, and is computed once, in one jitted ``value_and_grad``.

Tolerances: 1e-5 for single functions; the loss dict at rtol 1e-4 and the
gradients at atol 1e-4 / rtol 1e-3 (deep f32 sums in another order, JAX at
``highest`` matmul precision, see conftest); the optimizer update at 1e-6
on the same gradients.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
# loaded while the file is collected: see tests/test_torch_trainable_bn.py
import torch._dynamo  # noqa: F401

from pavenet_tpu.apis import train as jtrain
from pavenet_tpu.core import assigner as jassigner
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu.models.flows.realnvp import RealNVP as JRealNVP
from pavenet_tpu.models.losses import OKS_SIGMAS as J_OKS_SIGMAS
from pavenet_tpu.models.losses import rle_loss as j_rle_loss
from pavenet_tpu.models.losses import sigmoid_focal_loss as j_focal
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu.ops.lap import hungarian_masked as j_hungarian_masked
from pavenet_tpu_torch.apis import train as ttrain
from pavenet_tpu_torch.core import assigner as tassigner
from pavenet_tpu_torch.models import VideoPoseDetector
from pavenet_tpu_torch.models.flows.realnvp import RealNVP
from pavenet_tpu_torch.models.losses import (OKS_SIGMAS, rle_loss,
                                             sigmoid_focal_loss)
from pavenet_tpu_torch.models.zoo import dummy_clip_batch
from pavenet_tpu_torch.ops.lap import hungarian_masked
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict

TINY = dict(num_frames=3, num_keypoints=15, num_query=12, backbone_depth=18,
            embed_dims=64, num_encoder_layers=1, num_decoder_layers=2,
            num_refine_layers=1, max_per_img=5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t = torch.from_numpy


def noised(variables, seed=0, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(
            np.float32), jax.device_get(variables))


def port_name(path) -> str:
    """Dotted port name of a JAX parameter path (leaf renamed)."""
    keys = [getattr(k, "key", str(k)) for k in path]
    leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf])


def train_batch():
    return j_dummy_clip_batch(np.random.RandomState(1), batch_size=2,
                              height=64, width=96, max_gt=8, train=True)


@pytest.fixture(scope="module")
def jax_side():
    model = JDetector(max_gt=8, dropout=0.0, **TINY)
    batch = train_batch()
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        b, train=True))(batch)
    variables = noised(variables)

    def loss_fn(params):
        losses = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             batch, train=True)
        return losses["loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return (variables, batch, jax.tree.map(np.asarray, losses),
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def port_side(jax_side):
    variables, batch = jax_side[:2]
    model = VideoPoseDetector(dropout=0.0, **TINY)
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    model.train()
    losses = model.forward_train({k: t(v) for k, v in batch.items()})
    losses["loss"].backward()
    return model, {k: v.item() for k, v in losses.items()}


# ----------------------------------------------------------------------
# single functions
# ----------------------------------------------------------------------
def test_realnvp_log_prob():
    x = np.random.RandomState(0).randn(64, 2).astype(np.float32)
    jflow = JRealNVP()
    variables = noised(jax.jit(jflow.init)(jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(functools.partial(
        jflow.apply, method=jflow.log_prob))(variables, x))
    flow = RealNVP()
    flow.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = flow.log_prob(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sigmoid_focal_loss():
    rng = np.random.RandomState(1)
    logits = rng.randn(40, 1).astype(np.float32) * 3
    labels = rng.randint(0, 2, 40)
    want = float(j_focal(logits, labels, avg_factor=7.0))
    got = sigmoid_focal_loss(t(logits), t(labels), avg_factor=7.0).item()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rle_loss():
    rng = np.random.RandomState(2)
    shape = (2, 3, 15, 2)
    pred, target = rng.rand(*shape), rng.rand(*shape)
    sigma = rng.rand(*shape) * 0.3 + 1e-3
    weight = (rng.rand(*shape[:-1], 1) > 0.3).repeat(2, -1)
    log_phi = rng.randn(*shape[:-1])
    args = [a.astype(np.float32) for a in
            (pred, sigma, target, weight, log_phi)]
    want = float(j_rle_loss(*args, 11.0, 0.5))
    got = rle_loss(*map(t, args), 11.0, 0.5).item()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_oks_sigmas_equal():
    for k, s in J_OKS_SIGMAS.items():
        np.testing.assert_array_equal(OKS_SIGMAS[k], s)


def _cost_inputs(seed=3, B=2, Q=20, G=6, K=15):
    rng = np.random.RandomState(seed)
    cls = rng.randn(B, Q, 1).astype(np.float32)
    kpt = rng.rand(B, Q, K, 2).astype(np.float32)
    gt = rng.rand(B, G, K, 3).astype(np.float32)
    gt[..., 0] *= 90
    gt[..., 1] *= 60
    gt[..., 2] = gt[..., 2] > 0.3
    gt[0, 0, :, 2] = 0          # no visible joint
    areas = (rng.rand(B, G) * 3e3).astype(np.float32)
    areas[1, 2] = 0.0           # degenerate area
    valid = rng.rand(B, G) > 0.3
    img_shape = np.array([[60, 90], [64, 85]], np.int32)
    return cls, kpt, gt, areas, valid, img_shape


def test_pose_match_cost():
    cls, kpt, gt, areas, _, img_shape = _cost_inputs()
    want = np.asarray(jax.vmap(jassigner.pose_match_cost)(
        cls, kpt, gt, areas, img_shape))
    got = tassigner.pose_match_cost(
        t(cls), t(kpt), t(gt), t(areas), t(img_shape),
        torch.tensor(OKS_SIGMAS[15])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _lap_cases():
    """The cases of ``tests/test_lap.py``: random square and rectangular,
    tied, masked; plus small-integer costs full of ties."""
    rng = np.random.RandomState(0)
    cases = []
    for _ in range(20):
        R = rng.randint(1, 12)
        C = rng.randint(R, 40)
        cases.append((rng.randn(R, C).astype(np.float32) * 10,
                      np.ones(R, bool)))
    cases.append((np.zeros((4, 6), np.float32), np.ones(4, bool)))
    cases.append((rng.randint(0, 3, (6, 9)).astype(np.float32),
                  np.ones(6, bool)))
    cases.append((rng.rand(8, 20).astype(np.float32),
                  np.array([True] * 3 + [False] * 5)))
    cases.append((rng.randint(0, 2, (8, 20)).astype(np.float32),
                  np.array([True, False] * 4)))
    return cases


@pytest.mark.parametrize("case", range(len(_lap_cases())))
def test_hungarian_masked_equals_jax(case):
    cost, valid = _lap_cases()[case]
    want = np.asarray(j_hungarian_masked(cost, valid))
    np.testing.assert_array_equal(hungarian_masked(cost, valid), want)


def test_assignment_and_targets_equal():
    cls, kpt, gt, areas, valid, img_shape = _cost_inputs(seed=4)
    Q = cls.shape[1]
    jassign = jax.vmap(jassigner.pose_hungarian_assign)(
        cls, kpt, gt, areas, valid, img_shape)
    jtargets = jax.vmap(lambda a, k, ar, s: jassigner.build_pose_targets(
        a, k, ar, s, Q))(jassign, gt, areas, img_shape)
    cost = tassigner.pose_match_cost(
        t(cls), t(kpt), t(gt), t(areas), t(img_shape),
        torch.tensor(OKS_SIGMAS[15]))
    (idx,) = tassigner.hungarian_assign([cost], t(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jassign.query_idx))
    targets = tassigner.build_pose_targets(
        idx, t(valid), t(gt), t(areas), t(img_shape), Q)
    for name in jtargets._fields:
        want = np.asarray(getattr(jtargets, name))
        got = getattr(targets, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


# ----------------------------------------------------------------------
# the slice: forward_train, gradients, labels, optimizer, schedules
# ----------------------------------------------------------------------
def test_converter_consumes_train_tree(jax_side):
    variables = jax_side[0]
    sd = jax_variables_to_state_dict(variables)
    assert len(sd) == len(jax.tree.leaves(variables))
    assert set(sd) == set(VideoPoseDetector(**TINY).state_dict())


def test_forward_train_losses_match(jax_side, port_side):
    want, got = jax_side[2], port_side[1]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_every_gradient_matches(jax_side, port_side):
    model = port_side[0]
    want = jax_variables_to_state_dict({"params": jax_side[3]})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)


def test_param_labels_equal(jax_side):
    params = jax_side[0]["params"]
    names = dict(VideoPoseDetector(**TINY).named_parameters())
    labels = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map_with_path(
            lambda path, _: (port_name(path), jtrain._param_label(path)),
            params), is_leaf=lambda x: isinstance(x, tuple))[0]
    assert len(labels) == len(names)
    for _, (name, want) in labels:
        assert name in names
        assert ttrain._param_label(name) == want, name
    assert {w for _, (_, w) in labels} == {"frozen", "backbone", "slow",
                                           "base"}


def test_one_update_matches_optax(jax_side):
    """Two mini-batches of the same random gradients through the optax
    chain (accumulate 2, clip 0.1) and through the port's optimizer."""
    params = jax_side[0]["params"]
    rng = np.random.RandomState(5)
    grads = [jax.tree.map(lambda x: rng.randn(*np.shape(x)).astype(
        np.float32), params) for _ in range(2)]
    lr = 1e-3
    tx = jtrain.build_optimizer(params, learning_rate=lr, grad_clip=0.1,
                                accumulate_steps=2)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def step(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    jparams = params
    for g in grads:
        jparams, opt_state = step(g, opt_state, jparams)
    want = jax_variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, jparams)})

    model = VideoPoseDetector(**TINY)
    model.load_state_dict(jax_variables_to_state_dict(jax_side[0]),
                          strict=True)
    state = ttrain.TrainState(
        model=model, optimizer=ttrain.build_optimizer(model),
        schedule=lambda step: lr, grad_clip=0.1, accumulate_steps=2,
        generator=torch.Generator(), max_gt=8)
    for g in grads:
        gsd = jax_variables_to_state_dict({"params": g})
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        ttrain.accumulate(state)
    assert state.updates == 1 and state.mini_step == 0
    before = jax_variables_to_state_dict(jax_side[0])
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6,
                                   rtol=0, err_msg=name)
        moved += not torch.equal(want[name], before[name])
    assert moved > 0


LR_CONFIGS = {
    "step": dict(policy="step", step=[8, 15]),
    "step_linear_warmup": dict(policy="step", step=[10], warmup="linear",
                               warmup_iters=200, warmup_ratio=0.001),
    "cosine": dict(policy="cosine", min_lr_ratio=0.01),
    "cosine_constant_warmup": dict(policy="CosineAnnealing", min_lr=1e-6,
                                   warmup="constant", warmup_iters=100,
                                   warmup_ratio=0.1),
    "step_exp_warmup": dict(policy="step", step=[20], gamma=0.5,
                            warmup="exp", warmup_iters=300,
                            warmup_ratio=0.01),
}


@pytest.mark.parametrize("name", sorted(LR_CONFIGS))
def test_lr_schedule_matches(name):
    cfg = LR_CONFIGS[name]
    jsched = jax.jit(jtrain.build_lr_schedule(cfg, 2e-4, 20, 20))
    steps = np.arange(501)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
    sched = ttrain.build_lr_schedule(cfg, 2e-4, 20, 20)
    got = np.array([sched(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_init_trainer_reads_config():
    state = ttrain.init_trainer(
        os.path.join(REPO, "configs/videopose/pavenet_tiny_debug.py"),
        device="cpu")
    assert (state.accumulate_steps, state.grad_clip, state.max_gt) == (
        2, 0.1, 10)
    groups = {g["label"]: g["lr_mult"] for g in state.optimizer.param_groups}
    assert groups == {"base": 1.0, "backbone": 0.1, "slow": 0.1}
    assert state.schedule(0) == pytest.approx(2e-5)
    batch = dummy_clip_batch(np.random.RandomState(0), height=64, width=96,
                             max_gt=state.max_gt, train=True)
    assert set(ttrain.train_step(state, batch)) >= {"loss", "enc_loss_kpt"}
    assert state.mini_step == 1 and state.updates == 0
