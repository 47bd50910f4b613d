"""``tools/get_flops.py`` of the port against the JAX package, on the CPU.

- The parameter count and its per-module breakdown of eight full-width
  configs (the flagship, Swin-L, T=5, PETR R50, PETR HRNet-W48, SOIT R50,
  DK-DETR and InsPose), the port built on the ``meta`` device, equal
  exactly JAX's ``params`` plus ``batch_stats`` of ``jax.eval_shape`` of
  the inference init (no weights are made on either side), the count the
  JAX CLI prints.
- ``main(argv)`` on the tiny configs (deformable and windowed) with
  ``--device cpu``: the same count as the meta build, positive FLOPs, one
  msda (window-attention) call counted per layer that makes one, and the
  kernels' plain versions outside the torch counter. The window formula of
  ``ops/flops.py`` equals what the counter counts of the plain version's
  two products exactly, and the msda formula counts every tap.

FLOPs are the port's own: they are not compared with XLA's cost analysis.
"""
import math
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.zoo import dummy_clip_batch as j_dummy_clip_batch
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import build_detector
from pavenet_tpu_torch.ops import flops as kflops
from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from pavenet_tpu_torch.ops.window_attn import window_attention_levels
from pavenet_tpu_torch.tools import get_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("configs/videopose/pavenet_r50_frames3_posetrack17.py",
           "configs/videopose/pavenet_swin_frames3_posetrack18.py",
           "configs/videopose/pavenet_r50_frames5_posetrack17.py",
           "configs/petr/petr_r50_16x2_100e_coco.py",
           "configs/petr/petr_hrnetw48_16x2_100e_coco.py",
           "configs/soit/soit_r50_16x2_50e_coco.py",
           "configs/dk-detr/dkd_r50_70e_lvis.py",
           "configs/inspose/inspose_r50_8x4_3x_coco.py")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the suite runs six workers on one shared
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_counts(path, H=128, W=192):
    """The JAX CLI's counts from ``jax.eval_shape`` of its inference init
    on its batch (the counts do not depend on the input size)."""
    model = jax_build_detector(JConfig.fromfile(path).model)
    rng = np.random.RandomState(0)
    if hasattr(model, "num_frames"):
        batch = j_dummy_clip_batch(rng, num_frames=model.num_frames,
                                   height=H, width=W,
                                   num_keypoints=model.num_keypoints)
    else:
        batch = dict(img=rng.randn(1, H, W, 3).astype(np.float32),
                     img_shape=np.array([[H, W - 11]], np.int32),
                     scale_factor=np.ones((1, 2), np.float32))
        if getattr(model, "cls_emb_dim", 0):
            batch["text_feats"] = rng.randn(
                model.num_classes, model.cls_emb_dim).astype(np.float32)
    tree = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        batch, train=False))

    def count(t):
        return sum(math.prod(x.shape) for x in jax.tree.leaves(t))
    params = tree["params"]
    return (count(params) + count(tree.get("batch_stats", {})),
            {name: count(params[name]) for name in sorted(params)})


@pytest.mark.parametrize("config", CONFIGS)
def test_param_counts_match_jax(config):
    path = os.path.join(REPO, config)
    with torch.device("meta"):
        counts = get_flops.count_params(
            build_detector(Config.fromfile(path).model))
    total, modules = jax_counts(path)
    assert counts["total"] == total
    assert counts["modules"] == modules


def test_main_counts_on_the_cpu():
    for name, msda_calls, window_calls in (("pavenet_tiny_debug.py", 4, 0),
                                           ("pavenet_tiny_debug_windowed.py",
                                            3, 1)):
        path = os.path.join(REPO, "configs/videopose", name)
        res = get_flops.main([path, "--device", "cpu", "--shape", "96",
                              "128"])
        with torch.device("meta"):
            want = get_flops.count_params(
                build_detector(Config.fromfile(path).model))
        assert res["params"] == want["total"] > 0
        assert res["train_only"] == want["train_only"] > 0   # the flows
        f = res["flops"]
        assert (f["msda_calls"], f["window_attn_calls"]) == (msda_calls,
                                                              window_calls)
        assert f["torch"] > 0 and f["msda"] > 0
        assert (f["window_attn"] > 0) == bool(window_calls)
        assert f["total"] == f["torch"] + f["msda"] + f["window_attn"]
        assert res["input"] == (1, 3, 96, 128, 3)


def test_kernel_formulas_and_the_counter():
    gen = torch.Generator().manual_seed(0)
    # window attention: two levels of one layer, 8x16 windows
    shapes = ((2, 16, 32, 64), (2, 8, 16, 64))
    qs, ks, vs = ([torch.randn(s, generator=gen) for s in shapes]
                  for _ in range(3))
    keeps = [torch.ones(s[:3]) for s in shapes]
    with FlopCounterMode(display=False) as plain:
        window_attention_levels(qs, ks, vs, keeps, num_heads=8)
    with kflops.kernel_flops() as tally, \
            FlopCounterMode(display=False) as counter:
        window_attention_levels(qs, ks, vs, keeps, num_heads=8)
    assert counter.get_total_flops() == 0
    assert tally["window_attn"] == kflops.window_flops(shapes) \
        == plain.get_total_flops() > 0
    assert tally["window_attn_calls"] == 1
    # msda: every tap of the call counts, in range or not
    levels = ((6, 8), (3, 4))
    B, Q, H, L, P, D = 2, 5, 4, 2, 3, 8
    value = torch.randn(B, sum(h * w for h, w in levels), H, D,
                        generator=gen)
    loc = torch.rand(B, Q, H, L, P, 2, generator=gen) * 1.4 - 0.2
    attn = torch.rand(B, Q, H, L, P, generator=gen)
    with kflops.kernel_flops() as tally, \
            FlopCounterMode(display=False) as counter:
        ms_deform_attn(value, levels, loc, attn)
    assert counter.get_total_flops() == 0
    assert tally["msda"] == kflops.msda_flops(B * Q * H * L * P, D) \
        == B * Q * H * L * P * D * kflops.MSDA_FWD_FLOPS
    assert tally["msda_calls"] == 1
    assert kflops.msda_flops(7, 2, backward=True) == 7 * 2 * 34
    # outside a tally nothing is recorded and nothing is hidden
    with FlopCounterMode(display=False) as counter:
        window_attention_levels(qs, ks, vs, keeps, num_heads=8)
    assert counter.get_total_flops() == plain.get_total_flops()
