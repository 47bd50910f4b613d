"""The port's HRNet backbone and the PETR-family configs against the JAX
package, on the CPU.

- HRNet-W32 on a 64x96 input: the port's init laid onto
  ``jax.eval_shape`` of the JAX init and noised with seeded numpy (the
  frozen statistics' variances kept positive), carried by
  ``utils/weight_convert.py`` and loaded strictly; each
  of the four branch maps within 1e-5 of its largest value in f32, and
  within 6e-2 of it with both sides in bf16 (flax's dtype policy; the chip
  check's ``BF16_STAGE_TOL``).
- The port's builder on the meta device: every config under
  ``configs/petr/`` and ``configs/petr/pretrained/`` builds with no JAX;
  the InsPose config builds an ``InsPoseDetector`` with JAX's fields
  (SOIT and DK-DETR build: ``tests/test_torch_soit_parts.py``).
- Four full-width configs (R50 PETR, HRNet-W48 PETR, Swin-L PETR on
  CrowdPose, HRNet-W48 video pretraining at T=3): the port's state dict has
  every key and shape of ``jax.eval_shape`` of the JAX train-mode init,
  converted, PETR's heatmap branch included where ``loss_hm`` weighs
  above 0 and absent where it weighs 0.

Few test items on purpose: pytest-xdist's ``loadfile`` queue takes files
with more tests first, and this file's JAX compile should not delay the
suite's longest files.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models.backbones.hrnet import HRNet as JHRNet
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import InsPoseDetector, build_detector
from pavenet_tpu_torch.models.backbones.hrnet import HRNet
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict
from tests.test_torch_swin import converted_shapes
from tests.test_torch_trainable_bn import port_weights_on_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hrnet_w32_branches_match_jax():
    x = np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: JHRNet(width=32).init(
        jax.random.PRNGKey(0), x))
    variables = port_weights_on_jax_tree(HRNet(32), shapes)
    sd = jax_variables_to_state_dict(variables)
    for jdtype, dtype, tol in ((jnp.float32, torch.float32, 1e-5),
                               (jnp.bfloat16, torch.bfloat16, 6e-2)):
        want = jax.jit(lambda v: JHRNet(width=32, dtype=jdtype).apply(
            v, x))(variables)
        net = HRNet(32, dtype=dtype)
        net.load_state_dict(sd, strict=True)
        assert net.out_channels == (32, 64, 128, 256)
        with torch.no_grad():
            got = net(t(x).permute(0, 3, 1, 2))
        assert [tuple(g.shape) for g in got] == [
            (1, 32, 16, 24), (1, 64, 8, 12), (1, 128, 4, 6), (1, 256, 2, 3)]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == dtype
            w = np.asarray(w, np.float32)
            err = np.abs(g.float().permute(0, 2, 3, 1).numpy() - w).max()
            assert err <= tol * np.abs(w).max(), (str(dtype), i, err)


def test_every_petr_config_builds():
    configs = sorted(glob.glob(os.path.join(REPO, "configs/petr/*.py"))
                     + glob.glob(os.path.join(REPO,
                                              "configs/petr/pretrained/*.py")))
    assert len(configs) == 11
    for path in configs:
        cfg = Config.fromfile(path)
        with torch.device("meta"):
            model = build_detector(cfg.model)
        head = cfg.model["bbox_head"]
        assert model.num_keypoints == head.get("num_keypoints", 17), path
        petr = "pretrained" not in path
        assert model.num_frames == (1 if petr else head["num_frames"]), path
        assert model.kpt_loss == ("l1" if petr else "rle"), path
        assert model.head.with_heatmap == petr, path
        assert (model.with_rescoring, model.with_nms) == (not petr,) * 2
        assert model.head.detach_decoder_refs == petr, path
    path = os.path.join(REPO, "configs/inspose/inspose_r50_8x4_3x_coco.py")
    with torch.device("meta"):
        model = build_detector(Config.fromfile(path).model)
    jmodel = jax_build_detector(JConfig.fromfile(path).model)
    assert isinstance(model, InsPoseDetector)
    assert model.num_keypoints == jmodel.num_keypoints == 17
    assert model.backbone.depth == jmodel.backbone_depth == 50
    assert model.max_per_img == jmodel.max_per_img == 100
    for field in ("strides", "center_sampling", "center_sample_radius",
                  "score_thr", "with_hm", "stacked_convs",
                  "stacked_convs_kpt", "stacked_convs_hm"):
        assert getattr(model, field) == getattr(jmodel, field), field


def test_full_width_configs_build_with_the_jax_tree():
    for config, heatmap, backbone_params in (
            ("petr_r50_16x2_100e_coco.py", True, 23_508_032),
            ("petr_hrnetw48_16x2_100e_coco.py", True, 65_325_120),
            ("petr_swin-l-p4-w7-224-22kto1k_16x1_100e_crowdpose.py", True,
             194_997_780),
            ("pretrained/petr_hrnet_num_frame_3_bs16_20e_coco_rle.py", False,
             65_325_120)):
        path = os.path.join(REPO, "configs/petr", config)
        with torch.device("meta"):
            model = build_detector(Config.fromfile(path).model)
        jmodel = jax_build_detector(JConfig.fromfile(path).model)
        assert (model.num_frames, model.num_keypoints) == (
            jmodel.num_frames, jmodel.num_keypoints)
        # 128x192: 510 tokens, enough for the 300 queries' top-k
        batch = j_dummy_clip_batch(
            np.random.RandomState(0), height=128, width=192,
            num_frames=model.num_frames, num_keypoints=model.num_keypoints,
            max_gt=jmodel.max_gt, train=True)
        tree = jax.eval_shape(lambda b: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, b, train=True), batch)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == converted_shapes(tree), config
        assert ("head.fc_hm.weight" in got) == heatmap, config
        n = sum(p.numel() for k, p in model.named_parameters()
                if k.startswith("backbone."))
        assert n == backbone_params, config
