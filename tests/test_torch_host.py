"""The port's own host modules against the JAX package's: the config loader
on every video config, and the test pipeline byte for byte."""
import glob
import os

import cv2
import numpy as np
import pytest

from pavenet_tpu.config import Config as JConfig
from pavenet_tpu.datasets.pipelines import transforms as jtf
from pavenet_tpu_torch.apis.inference import host_batch
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.models import build_detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO_CONFIGS = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "configs/videopose/*.py")))


@pytest.mark.parametrize("path", VIDEO_CONFIGS)
def test_config_fromfile_equals_jax(path):
    got = Config.fromfile(os.path.join(REPO, path))
    want = JConfig.fromfile(os.path.join(REPO, path)).to_dict()
    assert got == want
    assert got.model.bbox_head.num_keypoints == want["model"]["bbox_head"][
        "num_keypoints"]


def test_builder_refuses_what_is_not_ported():
    cfg = Config.fromfile(os.path.join(
        REPO, "configs/videopose/pavenet_tiny_debug_windowed.py"))
    cfg.model.bbox_head.transformer.encoder.mode = "swin"
    with pytest.raises(KeyError, match="encoder mode"):
        build_detector(cfg.model)
    cfg = Config.fromfile(os.path.join(
        REPO, "configs/videopose/pavenet_tiny_debug.py"))
    cfg.model.bbox_head.loss_kpt.type = "mmdet.SmoothL1Loss"
    with pytest.raises(KeyError, match="loss_kpt"):
        build_detector(cfg.model)


def jax_host_batch(results, img_scale):
    for tr in (jtf.Resize([img_scale], multiscale_mode="value"),
               jtf.Normalize(), jtf.PadToBucket(jtf.DEFAULT_BUCKETS),
               jtf.FormatBatch()):
        results = tr(results)
    return {k: np.asarray(results[k])[None]
            for k in ("img", "img_shape", "scale_factor")}


@pytest.mark.parametrize("hw,img_scale", [
    ((90, 150), (160, 96)),
    ((720, 1280), (1333, 800)),
    ((480, 360), (1333, 800)),
    ((300, 500), (640, 384)),
])
def test_host_batch_is_byte_identical(hw, img_scale):
    rng = np.random.RandomState(hw[0])
    clip = [rng.randint(0, 256, (*hw, 3)).astype(np.uint8) for _ in range(3)]
    got = host_batch(clip, 3, img_scale)
    want = jax_host_batch({
        "imgs": [np.asarray(im, np.float32) for im in clip],
        "img_shape": hw, "scale_factor": np.ones(2, np.float32)}, img_scale)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_host_batch_from_files_is_byte_identical(tmp_path):
    rng = np.random.RandomState(7)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"frame{i}.png")
        cv2.imwrite(path, rng.randint(0, 256, (120, 200, 3), np.uint8))
        paths.append(path)
    got = host_batch(paths, 3, (320, 192))
    want = jax_host_batch(jtf.LoadClip()({"frame_files": paths}), (320, 192))
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
