"""The port's clip-inference slice against the JAX detector.

Tiny model of ``tests/test_videopose_model.py`` (R18, 1/2/1
encoder/decoder/joint layers, 12 queries, max_per_img=5), B=1, T=3, 64x96,
f32 on the CPU. The JAX init is noised leaf by leaf with seeded numpy noise
and converted; both sides run the same numpy batch.

embed_dims is 64, not 32: with 32 channels the neck's GroupNorm(32) has one
channel per group, and on the 1x2 last level a group holds two nearly equal
values (variance ~1e-4 of the squared mean), where either side's f32
variance is off by about 1% and the two disagree at 1e-2.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.config import Config
from pavenet_tpu.models.detectors import VideoPoseDetector as JDetector
from pavenet_tpu_torch.models import (VideoPoseDetector, build_detector,
                                      dummy_clip_batch, pavenet_r50_frames3)
from pavenet_tpu_torch.utils.weight_convert import (
    FLOWS, jax_variables_to_state_dict, load_jax_variables)

TINY = dict(num_frames=3, num_keypoints=15, num_query=12, backbone_depth=18,
            embed_dims=64, num_encoder_layers=1, num_decoder_layers=2,
            num_refine_layers=1, max_per_img=5)
HEAD_KEYS = ("all_cls_scores", "all_kpt_preds", "all_sigma_preds",
             "enc_cls_scores", "enc_kpt_preds", "enc_sigma_preds",
             "frame_kpt_preds", "init_reference", "memory", "mask_flatten",
             "valid_ratios")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outputs_and_test(module, batch):
    outs = module.forward_outputs(batch["img"], batch["img_shape"])
    return {k: outs[k] for k in HEAD_KEYS}, module.forward_test(batch)


@pytest.fixture(scope="module")
def jax_side():
    model = JDetector(max_gt=4, **TINY)
    batch = dummy_clip_batch(np.random.RandomState(1), height=64, width=96)
    variables = jax.jit(lambda r, b: model.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch)
    rng = np.random.RandomState(0)
    variables = jax.tree.map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*np.shape(x)).astype(
            np.float32), jax.device_get(variables))
    run = jax.jit(lambda v, b: model.apply(v, b, method=_outputs_and_test))
    head, det = jax.tree.map(np.asarray, run(variables, batch))
    return variables, batch, head, det


@pytest.fixture(scope="module")
def port_side(jax_side):
    variables, batch, _, _ = jax_side
    model = VideoPoseDetector(**TINY).eval()
    load_jax_variables(model, variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        head = model.forward_outputs(tb["img"], tb["img_shape"])
        det = model.forward_test(tb)
    return ({k: head[k].numpy() for k in HEAD_KEYS},
            {k: v.numpy() for k, v in det.items()})


def test_converter_consumes_every_leaf(jax_side):
    """A serving-only tree (JAX init with train=False) has no flows: every
    leaf converts, the model's keys beyond it are the three flows' only,
    and it loads; the flows then keep the port's init."""
    variables = jax_side[0]
    n_leaves = len(jax.tree.leaves(variables))
    sd = jax_variables_to_state_dict(variables)
    assert len(sd) == n_leaves
    model = VideoPoseDetector(**TINY)
    flow_keys = {k for k in model.state_dict()
                 if k.split(".")[1] in FLOWS}
    assert len(flow_keys) == 3 * 6 * 2 * 3 * 2   # flows x nets x Dense x w/b
    assert set(sd) == set(model.state_dict()) - flow_keys
    before = model.head.flow.s0.Dense_0.weight.detach().clone()
    load_jax_variables(model, variables)
    assert torch.equal(model.head.flow.s0.Dense_0.weight, before)
    # PETR's heatmap branch converts like any subtree, and a model without
    # it refuses it; anything unknown raises, and so does a missing key
    # outside the flows
    extra = {"params": dict(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    extra["params"]["head"] = dict(extra["params"]["head"],
                                   fc_hm={"kernel": np.ones(
                                       (2, 2), np.float32)})
    assert set(jax_variables_to_state_dict(extra)) == set(sd) | {
        "head.fc_hm.weight"}
    with pytest.raises(KeyError, match="fc_hm"):
        load_jax_variables(model, extra)
    del extra["params"]["head"]["fc_hm"]
    extra["params"]["head"]["odd"] = {"embedding": np.ones(3, np.float32)}
    with pytest.raises(KeyError, match="odd/embedding"):
        jax_variables_to_state_dict(extra)
    del extra["params"]["head"]["odd"]
    del extra["params"]["head"]["enc_output"]
    with pytest.raises(KeyError, match="enc_output"):
        load_jax_variables(model, extra)


@pytest.mark.parametrize("key", HEAD_KEYS)
def test_head_outputs_match(jax_side, port_side, key):
    want, got = jax_side[2][key], port_side[0][key]
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_detections_match(jax_side, port_side):
    want, got = jax_side[3], port_side[1]
    assert got["det_kpts"].shape == (1, 5, 15, 3)
    assert got["det_bboxes"].shape == (1, 5, 5)
    np.testing.assert_allclose(got["det_kpts"], want["det_kpts"], atol=1e-2)
    np.testing.assert_allclose(got["det_bboxes"][..., 4],
                               want["det_bboxes"][..., 4], atol=1e-5)
    np.testing.assert_allclose(got["det_bboxes"][..., :4],
                               want["det_bboxes"][..., :4], atol=1e-2)
    np.testing.assert_array_equal(got["keep"], want["keep"])


def test_builder_maps_flagship_config_to_zoo_model():
    cfg = Config.fromfile(os.path.join(
        REPO, "configs/videopose/pavenet_r50_frames3_posetrack17.py"))
    built = {k: v.shape for k, v in build_detector(cfg.model)
             .state_dict().items()}
    zoo = {k: v.shape for k, v in pavenet_r50_frames3().state_dict().items()}
    assert built == zoo
    assert len(built) > 500


def run_without_jax(code, timeout=120):
    """Run ``code`` in a fresh interpreter at the repo root, at most
    ``timeout`` seconds; return the modules of jax, flax and the JAX package
    it loaded."""
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code) + (
        "\nprint(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'jaxlib', 'pavenet_tpu')))\n")], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_slice_runs_without_jax():
    """The port's serving slice, run alone, loads neither jax nor flax nor
    any module of the JAX package."""
    assert run_without_jax("""
        import sys
        import numpy as np
        from pavenet_tpu_torch.apis import inference_detector, init_detector
        model = init_detector("configs/videopose/pavenet_tiny_debug.py",
                              device="cpu", seed=0)
        rng = np.random.RandomState(0)
        clip = [rng.randint(0, 256, (90, 150, 3)).astype(np.uint8)
                for _ in range(3)]
        out = inference_detector(model, clip, img_scale=(160, 96))
        assert out["det_kpts"].shape == (5, 15, 3), out["det_kpts"].shape
        assert np.isfinite(out["det_kpts"]).all()
    """) == "[]"


def test_train_slice_runs_without_jax():
    """Two mini-steps (one applied update) of the tiny debug config's train
    step, run alone, load neither jax nor flax nor the JAX package."""
    assert run_without_jax("""
        import sys
        import numpy as np
        from pavenet_tpu_torch.apis import init_trainer, train_step
        from pavenet_tpu_torch.models.zoo import dummy_clip_batch
        state = init_trainer("configs/videopose/pavenet_tiny_debug.py",
                             device="cpu", seed=0)
        rng = np.random.RandomState(0)
        for _ in range(2):
            losses = train_step(state, dummy_clip_batch(
                rng, height=96, width=128, max_gt=state.max_gt, train=True))
            assert all(np.isfinite(float(v)) for v in losses.values())
        assert state.updates == 1, state.updates
    """) == "[]"
