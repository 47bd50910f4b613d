"""Trainable BatchNorm's parts and the from-scratch recipe around it: the
port against the JAX package on the CPU, cheap checks only (the train
step itself is in ``tests/test_torch_trainable_bn.py``).

The activation-dtype table of ``resolve_act_dtype`` and its error; the
ResNet-18 backbone with ``norm_eval=False`` at ``frozen_stages`` -1 and 1,
in train mode (stage outputs and the new running statistics of
``apply(..., train=True, mutable=['batch_stats'])``) and in eval mode (the
running statistics' formula), f32 against f32 at 1e-5 of each output's
and statistic's largest value; the optimizer labels of every parameter
against ``_param_label`` for four sets of flags; the builder and
``init_trainer`` on the synthetic recipe and VideoPoseV2.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.apis import train as jtrain
from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models import builder as jbuilder
from pavenet_tpu.models.backbones.resnet import ResNet as JResNet
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu_torch import config as tconfig
from pavenet_tpu_torch.apis import train as ttrain
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import VideoPoseDetector, build_detector
from pavenet_tpu_torch.models.backbones.resnet import (BatchNorm,
                                                       FrozenBatchNorm,
                                                       ResNet)
from pavenet_tpu_torch.utils.weight_convert import (
    batch_stats_to_numpy, jax_variables_to_state_dict)
from test_torch_trainable_bn import (REPO, TINY, jax_tree_shapes,
                                     leaves_by_port_name,
                                     port_weights_on_jax_tree, train_batch)

t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree_shapes():
    """The tiny model's JAX variable tree (shapes only); the norm and
    freezing flags do not change it."""
    return jax_tree_shapes(JDetector(max_gt=8, norm_eval=False, **TINY),
                           train_batch())


# ----------------------------------------------------------------------
# the dtype policy's table
# ----------------------------------------------------------------------
@pytest.mark.parametrize("act_dtype, override", [
    (None, None), (None, "auto"), ("bf16", None), ("bfloat16", "auto"),
    ("float32", "bf16"), ("bf16", "f32"), (None, "fp32"), ("fp32", None),
    ("bf16", "float32"), ("nope", None), (None, "f16")])
def test_resolve_act_dtype_matches_jax(act_dtype, override):
    cfg = {} if act_dtype is None else {"act_dtype": act_dtype}
    try:
        want = jbuilder.resolve_act_dtype(cfg, override)
    except KeyError:
        with pytest.raises(KeyError):
            tconfig.resolve_act_dtype(cfg, override)
        return
    got = tconfig.resolve_act_dtype(cfg, override)
    assert {jnp.float32: torch.float32,
            jnp.bfloat16: torch.bfloat16}[want] == got


# ----------------------------------------------------------------------
# the backbone alone, train and eval mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("frozen_stages", [-1, 1])
def test_resnet_train_and_eval_mode_match_jax(frozen_stages):
    """ResNet-18, norm_eval=False: stage outputs and the new running
    statistics of ``apply(..., train=True, mutable=['batch_stats'])``
    (frozen norms keep theirs), then the stage outputs in eval mode on the
    statistics before the step."""
    x = np.random.RandomState(3).randn(6, 40, 56, 3).astype(np.float32)
    jnet = JResNet(depth=18, norm_eval=False, frozen_stages=frozen_stages)
    torch.manual_seed(0)
    net = ResNet(18, norm_eval=False, frozen_stages=frozen_stages)
    shapes = jax.eval_shape(lambda a: jnet.init(jax.random.PRNGKey(0), a,
                                                train=True), x)
    variables = port_weights_on_jax_tree(net, shapes)
    net.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    (want, mutated), want_eval = jax.jit(lambda v, a: (
        jnet.apply(v, a, train=True, mutable=["batch_stats"]),
        jnet.apply(v, a, train=False)))(variables, x)
    with torch.no_grad():
        got_eval = net(t(x).permute(0, 3, 1, 2), train=False)
    got = net(t(x).permute(0, 3, 1, 2), train=True)
    for a, b in zip(got + got_eval, want + want_eval):
        b = np.asarray(b).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(a.detach().numpy(), b,
                                   atol=1e-5 * np.abs(b).max(), rtol=0)
    new = leaves_by_port_name(mutated["batch_stats"])
    old = leaves_by_port_name(variables["batch_stats"])
    mine = leaves_by_port_name(batch_stats_to_numpy(net))
    assert set(mine) == set(new)
    frozen = 0
    for k, b in new.items():
        np.testing.assert_allclose(mine[k], b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0, err_msg=k)
        frozen += np.array_equal(b, old[k])
    # the stem (2 leaves) and layer1's 2 blocks x 2 norms stay frozen
    assert frozen == (0 if frozen_stages < 0 else 2 + 8)
    kinds = {type(m) for m in net.modules()
             if isinstance(m, (BatchNorm, FrozenBatchNorm))}
    assert kinds == ({BatchNorm} if frozen_stages < 0
                     else {BatchNorm, FrozenBatchNorm})


# ----------------------------------------------------------------------
# optimizer labels and VideoPoseV2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("norm_eval, frozen_stages, v2", [
    (False, -1, False), (False, 1, False), (True, 1, True),
    (False, -1, True)])
def test_param_labels_match_jax(tree_shapes, norm_eval, frozen_stages,
                                v2):
    kw = dict(norm_eval=norm_eval, frozen_stages=frozen_stages,
              freeze_backbone_neck=v2, **TINY)
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(
            tree_shapes["params"])[0]:
        keys = [p.key for p in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                            keys[-1])
        want[".".join(keys[:-1] + [leaf])] = jtrain._param_label(
            path, v2, not norm_eval, frozen_stages)
    got = ttrain.param_labels(VideoPoseDetector(**kw))
    assert got == want
    if v2:
        assert {got[n] for n in got if n.startswith(("backbone.", "neck."))
                } == {"frozen"}
    elif not norm_eval:
        assert "backbone_norm" in set(got.values())


def test_converter_round_trips_batch_stats(tree_shapes):
    """A strict load of the JAX tree into trainable BatchNorm (no
    ``num_batches_tracked``), and the reverse reader gives the JAX
    ``batch_stats`` layout back."""
    init = VideoPoseDetector(norm_eval=False, frozen_stages=-1, **TINY)
    init.init_weights(torch.Generator().manual_seed(0))
    variables = port_weights_on_jax_tree(init, tree_shapes)
    model = VideoPoseDetector(norm_eval=False, frozen_stages=-1, **TINY)
    result = model.load_state_dict(jax_variables_to_state_dict(variables),
                                   strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert not any("num_batches_tracked" in k for k in model.state_dict())
    want = leaves_by_port_name(variables["batch_stats"])
    got = leaves_by_port_name(batch_stats_to_numpy(model))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ----------------------------------------------------------------------
# the builder and the trainer on the from-scratch recipe
# ----------------------------------------------------------------------
def test_builder_builds_the_synthetic_recipe_and_v2():
    path = os.path.join(
        REPO, "configs/videopose/pavenet_r50_frames3_synthetic_sm.py")
    cfg = Config.fromfile(path)
    jmodel = jbuilder.build_detector(JConfig.fromfile(path).model)
    model = build_detector(cfg.model)
    assert (model.norm_eval, model.frozen_stages, model.freeze_backbone_neck
            ) == (jmodel.norm_eval, jmodel.frozen_stages,
                  jmodel.freeze_backbone_neck) == (False, -1, False)
    assert isinstance(model.backbone.bn1, BatchNorm)
    assert isinstance(model.backbone.layer1_0.bn1, BatchNorm)
    cfg.model.type = "VideoPoseV2"
    jcfg = JConfig.fromfile(path).model
    jcfg["type"] = "VideoPoseV2"
    assert build_detector(cfg.model).freeze_backbone_neck is True
    assert jbuilder.build_detector(jcfg).freeze_backbone_neck is True
    # a PoseTrack config typed InsPose: JAX builds an InsPose from its
    # ResNet and the head's fields, and so does the port
    cfg.model.type = "InsPose"
    jcfg["type"] = "InsPose"
    jmodel = jbuilder.build_detector(jcfg)
    with torch.device("meta"):
        model = build_detector(cfg.model)
    assert type(jmodel).__name__ == type(model).__name__ == "InsPoseDetector"
    assert (model.num_keypoints, model.backbone.depth, model.max_per_img,
            model.center_sampling, model.strides) == (
                jmodel.num_keypoints, jmodel.backbone_depth,
                jmodel.max_per_img, jmodel.center_sampling, jmodel.strides)


def test_init_trainer_reads_the_synthetic_recipe():
    """The recipe's optimizer: backbone at the full lr (1e-4), trainable
    norm affines without weight decay, no accumulation, linear warmup from
    1e-4 * 0.001 over 500 updates."""
    state = ttrain.init_trainer(os.path.join(
        REPO, "configs/videopose/pavenet_r50_frames3_synthetic_sm.py"),
        device="cpu")
    groups = {g["label"]: (g["lr_mult"], g["weight_decay"], len(g["params"]))
              for g in state.optimizer.param_groups}
    assert set(groups) == {"base", "backbone", "backbone_norm", "slow"}
    assert groups["backbone"][:2] == (1.0, 1e-4)
    assert groups["backbone_norm"][:2] == (1.0, 0.0)
    assert groups["backbone_norm"][2] == 2 * (1 + 16 * 3 + 4)   # R50 norms
    assert state.accumulate_steps == 1
    assert state.schedule(0) == pytest.approx(1e-4 * 0.001)
    assert state.schedule(250) == pytest.approx(1e-4 * (1 - 0.5 * 0.999))
