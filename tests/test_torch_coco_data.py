"""The port's COCO-format keypoint datasets and the CrowdPose protocol
against the JAX package's, on the CPU.

A hand-written COCO-format json per family (COCO K=17, CrowdPose K=14 with
``crowdIndex``, PoseTrack K=15 with ``is_labeled``) over four seeded
96x128 and 80x120 images: people with and without keypoints, a crowd, an
image with no person and (PoseTrack) an unlabelled frame.

- ``CocoPoseDataset``, ``CocoVideoPoseDataset`` (T=3), ``CrowdPoseDataset``
  and ``PosetrackPoseDataset``: the same kept images in test and train
  mode, the same annotations (``get_ann``), and the same items through the
  test pipeline of the tiny config (uint8 and float), exactly.
- The COCO train path: the tiny config's train pipeline and ``ClipLoader``
  (B=2, two epochs, seed 3) give JAX's batches exactly, ``gt_bboxes``
  included, and ``model_feed`` sends ``gt_bboxes`` to a model with PETR's
  heatmap loss only.
- CrowdPose evaluation: ``evaluate_dataset`` gives JAX's dict (the
  ``keypoints_AP(E|M|H)`` keys and no ``coco/`` key) on seeded detections,
  and ``tools.eval_metric.main`` prints JAX's lines for the CrowdPose
  config, both in this process (the static scan of
  ``tests/test_torch_data.py`` keeps JAX out of the port's modules).
"""
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest

from pavenet_tpu.apis import test as jtest
from pavenet_tpu.datasets import coco_pose as jcoco_pose
from pavenet_tpu.datasets import extra as jextra
from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader
from pavenet_tpu.datasets.pipelines import transforms as jtf
from pavenet_tpu.utils.seed import set_random_seed as jax_set_random_seed
from pavenet_tpu_torch import datasets
from pavenet_tpu_torch.apis import test as ttest
from pavenet_tpu_torch.apis.train import MODEL_KEYS, feed_keys, model_feed
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.datasets.pipelines import transforms as tf
from pavenet_tpu_torch.models.zoo import petr_r50_coco
from pavenet_tpu_torch.tools import eval_metric
from pavenet_tpu_torch.utils.seed import set_random_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs/videopose/pavenet_tiny_debug.py")
CROWDPOSE = os.path.join(
    REPO, "configs/petr/petr_swin-l-p4-w7-224-22kto1k_16x1_100e_crowdpose.py")
FAMILIES = {   # name: (K, JAX class, port class, extra arguments)
    "coco": (17, jcoco_pose.CocoPoseDataset, datasets.CocoPoseDataset, {}),
    "coco_video": (17, jcoco_pose.CocoVideoPoseDataset,
                   datasets.CocoVideoPoseDataset, dict(num_frames=3)),
    "crowdpose": (14, jextra.CrowdPoseDataset, datasets.CrowdPoseDataset,
                  {}),
    "posetrack": (15, jextra.PosetrackPoseDataset,
                  datasets.PosetrackPoseDataset, {}),
}


def write_family(root, K, seed=0):
    """Four images and their people as a COCO-format json; returns its
    path."""
    rng = np.random.RandomState(seed)
    sizes = ((96, 128), (80, 120), (96, 128), (80, 120))
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        name = f"img{i}.jpg"
        cv2.imwrite(str(root / name),
                    rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        images.append(dict(id=i + 1, file_name=name, height=h, width=w,
                           crowdIndex=[0.05, 0.5, 0.9, 0.3][i],
                           is_labeled=i != 3))
        if i == 2:     # an image with no person
            continue
        for p in range(3):
            k = np.zeros((K, 3))
            k[:, 0] = rng.uniform(5, w - 5, K)
            k[:, 1] = rng.uniform(5, h - 5, K)
            k[:, 2] = (rng.rand(K) > 0.3) * 2
            if p == 2 and i == 1:    # a person without keypoints
                k[:] = 0
            vis = k[:, 2] > 0
            x0, y0 = (k[vis, :2].min(0) - 4 if vis.any() else (10, 10))
            x1, y1 = (k[vis, :2].max(0) + 4 if vis.any() else (30, 40))
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1,
                keypoints=k.reshape(-1).round(2).tolist(),
                num_keypoints=int(vis.sum()),
                bbox=[float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                area=float((x1 - x0) * (y1 - y0)),
                iscrowd=int(p == 1 and i == 0)))
    path = root / "ann.json"
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=1, name="person")]), f)
    return path


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    out = {}
    for name, (K, *_) in FAMILIES.items():
        root = tmp_path_factory.mktemp(name)
        out[name] = (root, write_family(root, K))
    return out


def same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def test_datasets_match_jax(families):
    kwargs = Config.fromfile(TINY)["test_pipeline_kwargs"]
    for name, (K, jcls, cls, extra) in FAMILIES.items():
        root, ann = families[name]
        common = dict(ann_file=str(ann), img_prefix=str(root) + "/", **extra)
        for test_mode in (True, False):
            jds = jcls(test_mode=test_mode, **common)
            ds = cls(test_mode=test_mode, **common)
            want = [info["id"] for info in jds.data_infos]
            assert [info["id"] for info in ds.data_infos] == want
            assert len(want) == {("posetrack", True): 3,
                                 ("posetrack", False): 2}.get(
                                     (name, test_mode), 4 if test_mode else 3)
            for i in range(len(ds)):
                same(ds.get_ann(i), jds.get_ann(i), f"{name} ann {i}")
        assert ds.NUM_KEYPOINTS == K and ds.EVAL_PROTOCOL == jds.EVAL_PROTOCOL
        assert ds.FLIP_PAIRS == jds.FLIP_PAIRS
        for on in (True, False):
            pipe = dict(kwargs, normalize_on_device=on)
            jds = jcls(test_mode=True, pipeline=jtf.build_test_pipeline(
                **pipe), **common)
            ds = cls(test_mode=True, pipeline=tf.build_test_pipeline(**pipe),
                     **common)
            for i in range(len(ds)):
                got, want = ds.prepare(i), jds[i]
                same(got, want, f"{name} item {i}")
                assert got["img"].shape[0] == extra.get("num_frames", 1)


def test_coco_train_loader_matches_jax(families):
    root, ann = families["coco"]
    cfg = Config.fromfile(TINY)
    kwargs = dict(cfg["train_pipeline_kwargs"], normalize_on_device=True)
    common = dict(ann_file=str(ann), img_prefix=str(root) + "/")
    opts = dict(batch_size=2, max_gt=4, num_keypoints=17, shuffle=True,
                seed=3)
    jloader = JClipLoader(jcoco_pose.CocoPoseDataset(
        pipeline=jtf.build_train_pipeline(**kwargs), **common), **opts)
    loader = datasets.ClipLoader(datasets.CocoPoseDataset(
        pipeline=tf.build_train_pipeline(**kwargs), **common),
        rng=set_random_seed(3), **opts)
    jax_set_random_seed(3)
    want = [[dict(b) for b in jloader] for _ in range(2)]
    got = [[dict(b) for b in loader] for _ in range(2)]
    same(got, want, "batches")
    batch = got[0][0]
    assert batch["gt_bboxes"].shape == (2, 4, 4)
    assert batch["img"].shape[:2] == (2, 1)
    petr = petr_r50_coco(backbone_depth=18, embed_dims=64, num_query=12)
    assert feed_keys(petr) == MODEL_KEYS + ("gt_bboxes",)
    assert feed_keys(petr_r50_coco(backbone_depth=18, embed_dims=64,
                                   num_query=12, with_heatmap=False,
                                   loss_hm_weight=0.0)) == MODEL_KEYS
    fed = model_feed(batch, "cpu", keys=feed_keys(petr))
    assert set(fed) == set(MODEL_KEYS) | {"gt_bboxes"}
    np.testing.assert_array_equal(fed["gt_bboxes"].numpy(),
                                  batch["gt_bboxes"])


def crowd_detections(ann, seed=1):
    """The CrowdPose json's people jittered, with seeded scores, plus one
    false positive per image."""
    rng = np.random.RandomState(seed)
    dets = []
    for a in ann["annotations"]:
        k = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
        k[:, :2] += rng.randn(len(k), 2) * 3.0
        k[:, 2] = rng.rand(len(k))
        dets.append(dict(image_id=a["image_id"], category_id=1,
                         keypoints=k.reshape(-1).tolist(),
                         score=float(rng.rand())))
    for im in ann["images"]:
        k = np.concatenate([rng.rand(14, 1) * 120, rng.rand(14, 1) * 80,
                            rng.rand(14, 1)], 1)
        dets.append(dict(image_id=im["id"], category_id=1,
                         keypoints=k.reshape(-1).tolist(),
                         score=float(rng.rand())))
    return dets


def test_crowdpose_evaluation_matches_jax(families, tmp_path, capsys,
                                          monkeypatch):
    root, ann = families["crowdpose"]
    with open(ann) as f:
        dets = crowd_detections(json.load(f))
    common = dict(ann_file=str(ann), img_prefix=str(root) + "/",
                  test_mode=True)
    got = ttest.evaluate_dataset(datasets.CrowdPoseDataset(**common), dets)
    want = jtest.evaluate_dataset(jextra.CrowdPoseDataset(**common), dets)
    assert list(got) == list(want)
    assert {"keypoints_AP", "keypoints_AP(E)", "keypoints_AP(M)",
            "keypoints_AP(H)"} <= set(got)
    assert not any(k.startswith("coco/") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    assert 0.0 < got["keypoints_AP"] < 1.0

    out = tmp_path / "dets.json"
    with open(out, "w") as f:
        json.dump(dets, f)
    opts = ["--cfg-options", f"data.test.ann_file={ann}",
            f"data.test.img_prefix={root}/"]
    spec = importlib.util.spec_from_file_location(
        "jax_eval_metric", os.path.join(REPO, "tools/eval_metric.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["eval_metric.py", CROWDPOSE, str(out)]
                        + opts)
    jax_cli.main()
    want_lines = capsys.readouterr().out.splitlines()
    metrics = eval_metric.main([CROWDPOSE, str(out)] + opts)
    got_lines = capsys.readouterr().out.splitlines()
    assert got_lines == want_lines
    assert got_lines[0].startswith("keypoints_AP: ")
    assert list(metrics) == list(want)
