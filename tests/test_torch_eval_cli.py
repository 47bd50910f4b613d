"""The port's evaluation, inference loop, checkpoints and CLIs, on the CPU.

Synthetic PoseTrack scenes (JAX's generator: 2 train and 2 val videos of 4
frames at 96x128, seed 0) and the tiny debug config
(``configs/videopose/pavenet_tiny_debug.py``). Held against the JAX
package:

- the evaluators (``COCOKeypointEval``, ``CrowdPoseKeypointEval``,
  ``evaluate_posetrack_ap`` on ``frames_from_coco``, ``evaluate_dataset``)
  on the same seeded
  detections: identical metric dicts (1e-12); the oracle (GT as
  detections) at AP 1.0 and Mean AP 100;
- ``run_inference`` of the tiny model on the same weights (the port's
  seeded init laid onto ``jax.eval_shape`` of the JAX init, noised, carried
  by ``utils/weight_convert.py``) over the val scenes through each side's
  uint8 test chain: the same detections, keypoints within 1e-2 px, scores
  and per-joint scores within 1e-5, and the same metrics (1e-12).

And on the port alone: a checkpoint round trip (3 mini-steps, save,
restore into a trainer from another seed, 1 more) equal bit for bit to 4
mini-steps straight, with the EMA after an update at
``e * d + p * (1 - d)``; and the CLIs end to end in a fresh interpreter,
which loads no JAX module.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.apis import test as jtest
from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.core.eval import posetrack_eval as jposetrack_eval
from pavenet_tpu.core.eval.coco_keypoint_eval import (
    COCOKeypointEval as JCOCOKeypointEval,
    CrowdPoseKeypointEval as JCrowdPoseKeypointEval)
from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader
from pavenet_tpu.datasets.pipelines import transforms as jtf
from pavenet_tpu.datasets.posetrack import (
    PosetrackVideoPoseDataset as JDataset)
from pavenet_tpu.datasets.synthetic import main as jax_generate
from pavenet_tpu.models.builder import build_detector as jax_build_detector
from pavenet_tpu.models.losses.oks_loss import OKS_SIGMAS as JOKS_SIGMAS
from pavenet_tpu_torch.apis import test as ttest
from pavenet_tpu_torch.apis import train as ttrain
from pavenet_tpu_torch.apis.inference import build_model
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.core.eval import (COCOKeypointEval,
                                         CrowdPoseKeypointEval,
                                         evaluate_posetrack_ap,
                                         frames_from_coco)
from pavenet_tpu_torch.datasets import ClipLoader
from pavenet_tpu_torch.datasets.pipelines import transforms as tf
from pavenet_tpu_torch.datasets.posetrack import PosetrackVideoPoseDataset
from pavenet_tpu_torch.models.losses import OKS_SIGMAS
from pavenet_tpu_torch.utils.checkpoint import (find_latest_checkpoint,
                                                restore_checkpoint,
                                                restore_variables,
                                                save_checkpoint)
from pavenet_tpu_torch.utils.weight_convert import load_jax_variables
from tests.test_torch_trainable_bn import port_weights_on_jax_tree
from tests.test_torch_videopose import run_without_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs/videopose/pavenet_tiny_debug.py")
SCENES = ["--train-videos", "2", "--val-videos", "2", "--frames", "4",
          "--height", "96", "--width", "128", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small tensors: the suite runs six
    workers on one shared CPU, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    jax_generate(["--root", str(root)] + SCENES)
    return root


def datasets(root, split="val", pipelines=None):
    """The JAX and the port dataset of ``split``; ``pipelines`` is a
    (JAX, port) pair."""
    jpipe, pipe = pipelines or (None, None)
    common = dict(ann_file=str(root / f"{split}.json"),
                  img_prefix=str(root) + "/", num_frames=3, test_mode=True)
    return (JDataset(pipeline=jpipe, **common),
            PosetrackVideoPoseDataset(pipeline=pipe, **common))


def seeded_detections(root, oracle, seed=0):
    """GT as detections (``oracle``), or GT jittered by a few pixels with
    seeded scores plus one false positive per frame."""
    with open(root / "val.json") as f:
        ann = json.load(f)
    rng = np.random.RandomState(seed)
    dets = []
    for a in ann["annotations"]:
        k = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
        if not oracle:
            k[:, :2] += rng.randn(len(k), 2) * 4.0
            k[:, 2] = rng.rand(len(k))
        dets.append(dict(image_id=a["image_id"], category_id=1,
                         keypoints=k.reshape(-1).tolist(),
                         score=0.99 if oracle else float(rng.rand())))
    if not oracle:
        for im in ann["images"]:
            k = np.concatenate([rng.rand(15, 1) * 128, rng.rand(15, 1) * 96,
                                rng.rand(15, 1)], 1)
            dets.append(dict(image_id=im["id"], category_id=1,
                             keypoints=k.reshape(-1).tolist(),
                             score=float(rng.rand())))
    return dets


def assert_same_metrics(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "seeded"])
def test_evaluators_match_jax(scenes, oracle):
    jds, ds = datasets(scenes)
    dets = seeded_detections(scenes, oracle)
    np.testing.assert_array_equal(OKS_SIGMAS[15], JOKS_SIGMAS[15])
    coco = COCOKeypointEval(ds.coco, ds.coco.load_res(dets),
                            sigmas=OKS_SIGMAS[15], max_dets=30).evaluate()
    assert_same_metrics(coco, JCOCOKeypointEval(
        jds.coco, jds.coco.load_res(dets), sigmas=JOKS_SIGMAS[15],
        max_dets=30).evaluate())
    pt = evaluate_posetrack_ap(frames_from_coco(ds.coco, dets))
    jpt = jposetrack_eval.evaluate_posetrack_ap(
        jposetrack_eval.frames_from_coco(jds.coco, dets))
    np.testing.assert_array_equal(pt.pop("per_joint"), jpt.pop("per_joint"))
    assert_same_metrics(pt, jpt)
    crowd = CrowdPoseKeypointEval(ds.coco, ds.coco.load_res(dets),
                                  sigmas=OKS_SIGMAS[15]).evaluate()
    assert_same_metrics(crowd, JCrowdPoseKeypointEval(
        jds.coco, jds.coco.load_res(dets), sigmas=JOKS_SIGMAS[15]).evaluate())
    full = ttest.evaluate_dataset(ds, dets)
    assert_same_metrics(full, jtest.evaluate_dataset(jds, dets))
    if oracle:
        assert coco["AP"] == 1.0 and full["posetrack/Mean"] == 100.0, full
    else:
        assert 0.0 < full["coco/AP"] < 1.0 and 0 < pt["Mean"] < 100.0


def test_run_inference_matches_jax(scenes):
    """The tiny model over the 8 val clips, uint8 test chain on both
    sides."""
    jcfg = JConfig.fromfile(TINY)
    jmodel = jax_build_detector(jcfg.model)
    model = build_model(TINY, seed=0)
    batch = dict(img=np.zeros((1, 3, 192, 256, 3), np.float32),
                 img_shape=np.array([[96, 128]], np.int32),
                 scale_factor=np.ones((1, 2), np.float32))
    shapes = jax.eval_shape(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, train=False), batch)
    variables = port_weights_on_jax_tree(model, shapes, seed=1)
    load_jax_variables(model, variables)
    model.eval()
    kwargs = dict(Config.fromfile(TINY).test_pipeline_kwargs,
                  normalize_on_device=True)
    jds, ds = datasets(scenes, pipelines=(
        jtf.build_test_pipeline(**kwargs), tf.build_test_pipeline(**kwargs)))
    opts = dict(batch_size=1, shuffle=False, drop_last=False)
    want = jtest.run_inference(jmodel, variables, JClipLoader(jds, **opts))
    timing = {}
    got = ttest.run_inference(model, ClipLoader(ds, **opts), timing=timing)
    assert timing["clips"] == len(ds) == 8
    assert 0 < len(got) == len(want) <= 8 * jcfg.model.test_cfg.max_per_img
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        gk = np.asarray(g["keypoints"]).reshape(-1, 3)
        wk = np.asarray(w["keypoints"]).reshape(-1, 3)
        np.testing.assert_allclose(gk[:, :2], wk[:, :2], atol=1e-2, rtol=0)
        np.testing.assert_allclose(gk[:, 2], wk[:, 2], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5,
                                   rtol=0)
    assert_same_metrics(ttest.evaluate_dataset(ds, got),
                        jtest.evaluate_dataset(jds, want))


def test_checkpoint_resume_is_exact_and_ema_follows(scenes, tmp_path):
    """Mini-steps on uint8 loader batches with 2-step accumulation and an
    EMA: 3, a checkpoint, a fresh trainer (another seed) restored, 1 more,
    equal bit for bit to 4 straight (parameters, statistics, AdamW moments,
    the accumulated gradient, the EMA, the dropout generator, the losses);
    and the EMA after the first update at ``e * d + p * (1 - d)``."""
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict({"custom_hooks": [
        dict(type="ExpMomentumEMAHook", momentum=0.25)]})
    kwargs = dict(cfg.train_pipeline_kwargs, normalize_on_device=True)
    _, ds = datasets(scenes, "train",
                     (None, tf.build_train_pipeline(**kwargs)))
    batches = list(ClipLoader(ds, batch_size=1, max_gt=cfg.max_gt,
                              prefetch=0))[:4]
    assert batches[0]["img"].dtype == np.uint8

    def trainer(seed):
        return ttrain.init_trainer(cfg, device="cpu", seed=seed,
                                   steps_per_epoch=8)

    # the run straight through, checkpointed after its third mini-step
    straight = trainer(0)
    assert straight.ema_decay == 0.75 and straight.accumulate_steps == 2
    p0 = [p.detach().clone() for p in straight.model.parameters()]
    for i, b in enumerate(batches):
        losses = ttrain.train_step(straight, b)
        if i == 1:   # the first update: e = p0 d + p1 (1 - d)
            d = straight.ema_decay
            for e, a, p in zip(straight.ema, p0,
                               straight.model.parameters()):
                np.testing.assert_allclose(
                    e.numpy(), a.numpy() * d + p.detach().numpy() * (1 - d),
                    rtol=0, atol=1e-7)
            assert any(not torch.equal(a, p) for a, p in
                       zip(p0, straight.model.parameters()))
        if i == 2:
            assert (straight.updates, straight.mini_step,
                    straight.steps) == (1, 1, 3)
            save_checkpoint(str(tmp_path), straight, 2)   # pruned below
            path = save_checkpoint(str(tmp_path), straight, straight.steps,
                                   meta=dict(epoch=1), max_keep=1)
    assert os.listdir(tmp_path) == ["step_3.pt"]
    assert find_latest_checkpoint(str(tmp_path)) == path
    resumed = trainer(1)
    assert restore_checkpoint(path, resumed) == dict(epoch=1)
    resumed_losses = ttrain.train_step(resumed, batches[3])

    assert (resumed.updates, resumed.mini_step) == (straight.updates, 0) \
        == (2, 0)
    assert resumed.lr == straight.lr
    for k, v in losses.items():
        assert torch.equal(resumed_losses[k], v), k
    want = straight.state_dict()
    got = resumed.state_dict()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for (i, s), (j, t) in zip(want["optimizer"]["state"].items(),
                              got["optimizer"]["state"].items()):
        assert i == j and all(torch.equal(s[n], t[n]) for n in s), i
    assert got["acc"] is want["acc"] is None
    assert all(torch.equal(a, b) for a, b in zip(got["ema"], want["ema"]))
    assert torch.equal(got["generator"], want["generator"])
    assert set(restore_variables(path)) == set(want["model"])


def test_cli_path_runs_without_jax(tmp_path):
    """Generate scenes, train 2 mini-steps (one update, a checkpoint),
    resume for 1 more with the epoch's evaluation, test with ``--out``:
    each CLI's ``main`` in one fresh interpreter, which loads no JAX module.
    (TensorFlow is kept out of it: tensorboard runs without it, and its
    import alone takes longer than the rest.)"""
    assert run_without_jax(f"""
        import json, sys
        sys.modules["tensorflow"] = None
        import torch
        torch.set_num_threads(1)
        from pavenet_tpu_torch.datasets import synthetic
        from pavenet_tpu_torch.tools import test, train
        root, work = {str(tmp_path / 'data')!r}, {str(tmp_path / 'work')!r}
        synthetic.main(["--root", root] + {SCENES!r})
        opts = ["--cfg-options"] + [
            f"data.{{s}}.{{k}}={{root}}/{{v}}" for s, j in (
                ("train", "train"), ("val", "val"), ("test", "val"))
            for k, v in (("ann_file", j + ".json"), ("img_prefix", ""))]
        args = ["configs/videopose/pavenet_tiny_debug.py", "--work-dir",
                work, "--device", "cpu"]
        first = train.main(args + ["--max-steps", "2", "--no-validate"]
                           + opts)
        assert (first["steps"], first["updates"]) == (2, 1), first
        assert first["checkpoint"].endswith("step_2.pt"), first
        second = train.main(args + ["--max-steps", "3", "--auto-resume"]
                            + opts)
        assert second["resumed_from"] == first["checkpoint"], second
        assert (second["steps"], second["steps_run"]) == (3, 1), second
        assert "posetrack/Mean" in second["metrics"], second
        out = root + "/dets.json"
        res = test.main(["configs/videopose/pavenet_tiny_debug.py",
                         second["checkpoint"], "--out", out, "--device",
                         "cpu"] + opts)
        assert {{"coco/AP", "posetrack/Mean"}} <= set(res["metrics"]), res
        assert len(json.load(open(out))) == res["detections"] > 0, res
    """, timeout=300) == "[]"
