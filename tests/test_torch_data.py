"""The port's data path against the JAX package's, on the CPU.

Synthetic PoseTrack scenes (2 train and 2 val videos of 4 frames at
96x128, seed 0) written by both generators; the tiny debug config's train
and test pipelines (``configs/videopose/pavenet_tiny_debug.py``: scales
96-160, one 192x256 bucket) and ``ClipLoader`` over two epochs, the JAX
side seeded by ``set_random_seed`` (its global streams), the port given
the generators of its own ``set_random_seed``; the uint8 feed normalised by
``apis/prep.py`` against JAX's ``make_device_prep`` and the host chain.

Tolerances: json bytes, decoded images and uint8 batches exactly; float
batches 1e-6 (both sides run the same numpy and cv2 calls, so they agree
exactly in practice); the prep 1e-6 against JAX and against the host
Normalize -> PadToBucket chain at native scale.
"""
import ast
import glob
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from pavenet_tpu.apis.prep import make_device_prep
from pavenet_tpu.datasets import synthetic as jsynthetic
from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader
from pavenet_tpu.datasets.pipelines import transforms as jtf
from pavenet_tpu.datasets.posetrack import (
    PosetrackVideoPoseDataset as JDataset)
from pavenet_tpu.utils.seed import set_random_seed as jax_set_random_seed
from pavenet_tpu_torch.apis.prep import device_prep
from pavenet_tpu_torch.apis.train import MODEL_KEYS, model_feed
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.datasets import ClipLoader, synthetic
from pavenet_tpu_torch.datasets.pipelines import transforms as tf
from pavenet_tpu_torch.datasets.posetrack import PosetrackVideoPoseDataset
from pavenet_tpu_torch.models.zoo import dummy_clip_batch
from pavenet_tpu_torch.utils.seed import set_random_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs/videopose/pavenet_tiny_debug.py")
SCENES = ["--train-videos", "2", "--val-videos", "2", "--frames", "4",
          "--height", "96", "--width", "128", "--seed", "0"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX and the port generator's scenes, same arguments."""
    root = tmp_path_factory.mktemp("scenes")
    jsynthetic.main(["--root", str(root / "jax")] + SCENES)
    synthetic.main(["--root", str(root / "port")] + SCENES)
    return root


def test_generator_writes_the_same_scenes(scenes):
    for split in ("train", "val"):
        with open(scenes / "jax" / f"{split}.json", "rb") as f:
            want = f.read()
        with open(scenes / "port" / f"{split}.json", "rb") as f:
            assert f.read() == want, split
    frames = sorted(glob.glob(str(scenes / "jax" / "*/images/*/*.jpg")))
    assert len(frames) == 16
    for path in frames:
        rel = os.path.relpath(path, scenes / "jax")
        got = cv2.imread(str(scenes / "port" / rel))
        np.testing.assert_array_equal(got, cv2.imread(path), err_msg=rel)


def loaders(root, split, train, normalize_on_device, seed=3):
    """The JAX and the port ``ClipLoader`` of ``split``, with the tiny
    config's train or test pipeline."""
    cfg = Config.fromfile(TINY)
    key = "train_pipeline_kwargs" if train else "test_pipeline_kwargs"
    kwargs = dict(cfg[key], normalize_on_device=normalize_on_device)
    build = "build_train_pipeline" if train else "build_test_pipeline"
    common = dict(ann_file=str(root / f"{split}.json"),
                  img_prefix=str(root) + "/", num_frames=3,
                  test_mode=not train)
    jds = JDataset(pipeline=getattr(jtf, build)(**kwargs), **common)
    ds = PosetrackVideoPoseDataset(pipeline=getattr(tf, build)(**kwargs),
                                   **common)
    opts = (dict(batch_size=2, max_gt=cfg.max_gt, shuffle=True, seed=seed)
            if train else dict(batch_size=3, shuffle=False,
                               drop_last=False))
    return (JClipLoader(jds, **opts),
            ClipLoader(ds, rng=set_random_seed(seed), **opts))


def epochs(loader, n=2):
    return [[dict(b) for b in loader] for _ in range(n)]


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("normalize_on_device", [True, False],
                         ids=["uint8", "float"])
def test_pipelines_and_loader_give_jax_batches(scenes, train,
                                               normalize_on_device):
    root = scenes / "jax"
    jloader, loader = loaders(root, "train" if train else "val", train,
                              normalize_on_device)
    jax_set_random_seed(3)
    want = epochs(jloader)
    got = epochs(loader)
    assert [len(e) for e in got] == [len(e) for e in want] == [
        len(loader)] * 2
    assert len(loader) == (4 if train else 3)
    for e, (g_epoch, w_epoch) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(g_epoch, w_epoch)):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                assert g[k].shape == w[k].shape, k
                if w[k].dtype == np.uint8 or w[k].dtype.kind in "biu":
                    np.testing.assert_array_equal(
                        g[k], w[k], err_msg=f"epoch {e} batch {i} {k}")
                else:
                    np.testing.assert_allclose(
                        g[k], w[k], atol=1e-6, rtol=0,
                        err_msg=f"epoch {e} batch {i} {k}")
    img = got[0][0]["img"]
    assert img.dtype == (np.uint8 if normalize_on_device else np.float32)
    if train:   # the two epochs are shuffled apart
        assert not all(np.array_equal(a["image_id"], b["image_id"])
                       for a, b in zip(*got))
    else:       # the tail batch is repeat-padded, its pad row invalid
        assert got[0][-1]["_row_valid"].tolist() == [True, True, False]


def test_random_transforms_need_generators():
    results = {"imgs": [np.zeros((8, 8, 3), np.float32)],
               "gt_keypoints": np.zeros((0, 15, 3), np.float32)}
    with pytest.raises(ValueError, match="generators"):
        tf.RandomFlip(0.5)(results)
    assert tf.Compose([tf.Normalize()])(results) is results


def crop_input(rng):
    """A 3-frame 64x80 clip with two people, for the random crop."""
    kpts = np.concatenate([rng.rand(2, 15, 2) * [80, 64],
                           (rng.rand(2, 15, 1) > 0.3) * 2.0], -1)
    return dict(imgs=[rng.rand(64, 80, 3).astype(np.float32) * 255
                      for _ in range(3)],
                gt_keypoints=kpts.astype(np.float32),
                gt_bboxes=np.array([[5, 6, 40, 50], [30, 10, 78, 60]],
                                   np.float32),
                gt_areas=np.array([1500.0, 2000.0], np.float32),
                gt_labels=np.zeros(2, np.int64))


@pytest.mark.parametrize("crop_type, allow_negative", [
    ("absolute_range", True), ("absolute", False)])
def test_random_crop_matches_jax(crop_type, allow_negative):
    """``RandomCrop`` (in no built chain) against JAX's, 8 seeds: the same
    crops, GT and dropped samples."""
    for seed in range(8):
        sample = crop_input(np.random.RandomState(seed))
        args = ((20, 50), crop_type, allow_negative)
        jax_set_random_seed(seed)
        want = jtf.RandomCrop(*args)(
            {k: list(v) if k == "imgs" else v.copy()
             for k, v in sample.items()})
        got = tf.RandomCrop(*args)(sample, set_random_seed(seed))
        assert (got is None) == (want is None), seed
        if want is None:
            continue
        assert got["img_shape"] == want["img_shape"]
        for k in ("gt_keypoints", "gt_bboxes", "gt_areas", "gt_labels"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for a, b in zip(got["imgs"], want["imgs"]):
            np.testing.assert_array_equal(a, b)


def test_keypoint_utils_match_jax():
    from pavenet_tpu.core import keypoint as jkp
    from pavenet_tpu_torch.core import keypoint as kp
    rng = np.random.RandomState(0)
    points, offsets = rng.rand(6, 2) * 50, rng.randn(6, 30) * 20
    for shape in (None, (40, 60)):
        np.testing.assert_array_equal(
            kp.distance2keypoint(points, offsets, shape),
            jkp.distance2keypoint(points, offsets, shape))
    bboxes, labels, kpts = rng.rand(6, 5), rng.randint(0, 2, 6), \
        rng.rand(6, 15, 3)
    for got, want in zip(kp.bbox_kpt2result(bboxes, labels, kpts, 2),
                         jkp.bbox_kpt2result(bboxes, labels, kpts, 2)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for flip in (False, True):
        np.testing.assert_array_equal(
            kp.kpt_mapping_back(kpts, (40, 60), (0.5, 0.8), flip,
                                ((3, 4), (5, 6))),
            jkp.kpt_mapping_back(kpts, (40, 60), (0.5, 0.8), flip,
                                 ((3, 4), (5, 6))))
    for size in ((10, 20), (3.5, 80.0)):
        assert kp.gaussian_radius(size) == jkp.gaussian_radius(size)
    got, want = np.zeros((30, 40)), np.zeros((30, 40))
    for center, radius in (((5, 7), 4), ((38, 28), 6.5), ((0, 0), 2)):
        kp.draw_umich_gaussian(got, center, radius)
        jkp.draw_umich_gaussian(want, center, radius)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0


def test_device_prep_matches_jax_and_the_host_chain(scenes):
    """The uint8 test chain at native scale normalised by ``device_prep``:
    JAX's ``make_device_prep`` and the float host chain within 1e-6, the
    bucket padding exactly zero; a float feed passes through."""
    root = scenes / "jax"
    common = dict(ann_file=str(root / "val.json"),
                  img_prefix=str(root) + "/", num_frames=3, test_mode=True)
    kwargs = dict(img_scale=(128, 96), buckets=((192, 256),))
    batches = [next(iter(ClipLoader(PosetrackVideoPoseDataset(
        pipeline=tf.build_test_pipeline(normalize_on_device=on, **kwargs),
        **common), batch_size=2, shuffle=False, prefetch=0)))
        for on in (True, False)]
    u8, host = batches
    assert u8["img"].dtype == np.uint8
    got = device_prep({k: torch.from_numpy(u8[k])
                       for k in ("img", "img_shape")})["img"].numpy()
    want = np.asarray(jax.jit(make_device_prep())(
        {"img": u8["img"], "img_shape": u8["img_shape"]})["img"])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, host["img"], atol=1e-6, rtol=0)
    assert (u8["img_shape"] == [96, 128]).all()
    assert not got[:, :, 96:].any() and not got[:, :, :, 128:].any()
    feed = {"img": torch.ones(1, 3, 4, 4, 3),
            "img_shape": torch.tensor([[2, 2]])}
    assert device_prep(feed)["img"] is feed["img"]


def test_loader_batch_feeds_the_model_like_a_dummy_batch(scenes):
    """A ClipLoader train batch carries more keys than a dummy_clip_batch;
    ``model_feed`` sends both to the model with the same keys, dtypes and
    per-sample shapes, the uint8 image normalised."""
    _, loader = loaders(scenes / "jax", "train", True, True)
    batch = next(iter(loader))
    cfg = Config.fromfile(TINY)
    dummy = dummy_clip_batch(np.random.RandomState(0), 2, height=192,
                             width=256, max_gt=cfg.max_gt, train=True)
    assert set(batch) - set(dummy) == {"image_id", "_row_valid",
                                       "gt_bboxes"}
    got, want = (model_feed(b, "cpu") for b in (batch, dummy))
    assert set(got) == set(want) == set(dummy) == set(MODEL_KEYS)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
    assert torch.equal(got["img"], device_prep(
        {k: torch.from_numpy(batch[k]) for k in ("img", "img_shape")})["img"])


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pavenet_tpu")


def imported_roots(path):
    """The top-level package of every import of a Python file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_nothing_of_jax():
    """No file of the port, nor ``chip_smoke.py``, imports jax, jaxlib,
    flax, optax, orbax or the JAX package."""
    files = sorted(glob.glob(os.path.join(
        REPO, "pavenet_tpu_torch/**/*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 60
    assert {os.path.join(REPO, "pavenet_tpu_torch", f) for f in (
        "models/detectors/soit.py", "models/text_encoder.py",
        "core/eval/coco_det_eval.py", "core/eval/lvis_eval.py",
        "core/eval/voc_eval.py")} <= set(files)
    bad = [f"{os.path.relpath(f, REPO)}:{line} imports {root}"
           for f in files for root, line in imported_roots(f)
           if root in FORBIDDEN]
    assert bad == []
    # the scan sees this file's own imports of both packages
    assert {"jax", "pavenet_tpu", "pavenet_tpu_torch"} <= {
        root for root, _ in imported_roots(__file__)}
