"""The port's remaining user surface against the JAX package, on the CPU.

- ``utils/visualize.py``: ``draw_poses``, ``draw_boxes`` (boxes, labels,
  class names, masks) and ``render_detections`` draw exactly JAX's pixels
  from the same seeded detections, K = 14, 15 and 17 (tolerance: none,
  every pixel equal);
- the test CLI's ``--show --show-dir`` on the tiny config's scenes, with
  no ``DISPLAY``: it warns, and writes one image per test image equal,
  pixel for pixel, to JAX's ``render_detections`` of the same detections;
  ``show_results`` with masks and a missing image, against JAX's;
- the train CLI's ``synthetic_loader`` equals JAX's (``tools/train.py``,
  loaded by path) bit for bit over two epochs; ``--synthetic --max-steps 4
  --profile-dir`` on the tiny config writes a trace of mini-steps 3-4,
  with finite losses and no validation;
- ``keypoint2pseudo_box`` writes JAX's JSON;
- ``Config.fromstring``, ``pretty_text``, ``dump`` and deep copies, and
  the registry's ``split_scope_key`` and ``build_from_cfg``, as JAX's;
- ``rle_cost`` within 1e-5 (relative to the largest cost) of JAX's on the
  same flow weights (carried by ``utils/weight_convert.py``);
  ``pose_hungarian_assign`` gives JAX's ``query_idx``;
  ``step_lr_schedule`` within float32 rounding (1e-6 relative) of JAX's
  at and around each boundary; ``SinePositionalEncoding`` within 1e-6 of
  JAX's class.

Each CLI is called in-process through its ``main(argv)``.
"""
import copy
import importlib.util
import json
import logging
import math
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pavenet_tpu import config as jconfig
from pavenet_tpu import registry as jregistry
from pavenet_tpu.apis.train import step_lr_schedule as j_step_lr_schedule
from pavenet_tpu.core import assigner as jassigner
from pavenet_tpu.datasets.synthetic import main as jax_generate
from pavenet_tpu.models.flows.realnvp import RealNVP as JRealNVP
from pavenet_tpu.models.layers.positional_encoding import (
    SinePositionalEncoding as JSinePositionalEncoding)
from pavenet_tpu.utils import visualize as jvis
from pavenet_tpu_torch import config as tconfig
from pavenet_tpu_torch import registry as tregistry
from pavenet_tpu_torch.apis.inference import build_model
from pavenet_tpu_torch.apis.train import step_lr_schedule
from pavenet_tpu_torch.core import assigner as tassigner
from pavenet_tpu_torch.models.flows.realnvp import RealNVP
from pavenet_tpu_torch.models.layers import SinePositionalEncoding
from pavenet_tpu_torch.tools import test as test_cli
from pavenet_tpu_torch.tools import train as train_cli
from pavenet_tpu_torch.tools.dataset_converters import keypoint2pseudo_box
from pavenet_tpu_torch.utils import visualize as tvis
from pavenet_tpu_torch.utils.checkpoint import save_checkpoint
from pavenet_tpu_torch.utils.weight_convert import jax_variables_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs/videopose/pavenet_tiny_debug.py")
FLAGSHIP = os.path.join(REPO,
                        "configs/videopose/pavenet_r50_frames3_posetrack17.py")
SCENES = ["--train-videos", "1", "--val-videos", "2", "--frames", "4",
          "--height", "96", "--width", "128", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the suite runs six workers on one shared
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load_jax_script(*parts):
    """A JAX package script loaded by path (it is not a package module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_script_" + parts[-1].replace(".", "_"),
        os.path.join(REPO, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_image(rng, h=120, w=160):
    return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)


def seeded_dets(rng, K, n=6, h=120, w=160):
    """Pose detections (half of them under the 0.3 threshold) and box
    detections with masks, labels and scores."""
    kpts = np.concatenate([rng.rand(n, K, 1) * w, rng.rand(n, K, 1) * h,
                           rng.rand(n, K, 1)], -1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    boxes = np.sort(rng.rand(n, 2, 2) * [w, h], axis=1).reshape(n, 4)
    labels = rng.randint(0, 4, n)
    masks = rng.rand(n, h, w) > 0.7
    return kpts, scores, boxes, labels, masks


@pytest.mark.parametrize("K", [14, 15, 17])
def test_drawing_matches_jax(K, tmp_path):
    rng = np.random.RandomState(K)
    img = seeded_image(rng)
    kpts, scores, boxes, labels, masks = seeded_dets(rng, K)
    names = ("person", "bicycle", "car")   # label 3 has no name: its digit
    assert tvis.SKELETONS == jvis.SKELETONS
    np.testing.assert_array_equal(
        tvis.draw_poses(img.copy(), kpts, scores),
        jvis.draw_poses(img.copy(), kpts, scores))
    for kw in (dict(), dict(labels=labels, masks=masks, class_names=names)):
        np.testing.assert_array_equal(
            tvis.draw_boxes(img.copy(), boxes, scores, **kw),
            jvis.draw_boxes(img.copy(), boxes, scores, **kw))
    src = str(tmp_path / "src.png")
    cv2.imwrite(src, img)
    dets = [dict(image_id=1, category_id=1, score=float(s),
                 keypoints=k.reshape(-1).tolist())
            for k, s in zip(kpts, scores)]
    dets += [dict(image_id=1, category_id=int(c) + 1, score=float(s),
                  bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                        float(b[3] - b[1])], segmentation=m)
             for b, c, s, m in zip(boxes, labels, scores, masks)]
    got = tvis.render_detections(src, dets, out_file=str(tmp_path / "t.png"),
                                 class_names=names)
    want = jvis.render_detections(src, dets, class_names=names)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")), want)
    with pytest.raises(FileNotFoundError):
        tvis.render_detections(str(tmp_path / "missing.png"), dets)


def test_show_results_masks_and_missing_images(tmp_path, caplog):
    """Instance detections with masks and class names, and an image whose
    file is missing (warned about and skipped), as JAX's
    ``show_results``."""
    rng = np.random.RandomState(3)
    (tmp_path / "imgs").mkdir()
    cv2.imwrite(str(tmp_path / "imgs" / "a.png"), seeded_image(rng))
    _, scores, boxes, labels, masks = seeded_dets(rng, 17)

    class Dataset:
        img_prefix = str(tmp_path)
        data_infos = [dict(id=1, file_name="imgs/a.png"),
                      dict(id=2, file_name="imgs/gone.png")]
        CLASSES = ("cat", "dog", "bird", "fish")

    dets = [dict(image_id=i, category_id=int(c) + 1, score=float(s),
                 bbox=[float(b[0]), float(b[1]), float(b[2] - b[0]),
                       float(b[3] - b[1])], segmentation=m)
            for i in (1, 2) for b, c, s, m in zip(boxes, labels, scores,
                                                  masks)]
    logger = logging.getLogger("show_masks")
    with caplog.at_level(logging.WARNING, logger="show_masks"):
        n = test_cli.show_results(Dataset(), dets, str(tmp_path / "out"),
                                  0.3, logger)
    assert n == 1
    assert any("missing source image" in r.message for r in caplog.records)
    want = jvis.render_detections(str(tmp_path / "imgs" / "a.png"),
                                  dets[:len(boxes)],
                                  class_names=Dataset.CLASSES)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "out" / "imgs" / "a.png")), want)


class _ModelOnly:
    """What ``save_checkpoint`` writes of a trainer: here the model alone,
    which ``restore_variables`` reads."""

    def __init__(self, model):
        self.model = model

    def state_dict(self):
        return {"model": self.model.state_dict()}


def test_show_dir_renders_like_jax(tmp_path, monkeypatch, caplog):
    root = tmp_path / "scenes"
    jax_generate(["--root", str(root)] + SCENES)
    ckpt = save_checkpoint(str(tmp_path / "work"),
                           _ModelOnly(build_model(TINY, seed=0)), 0)
    opts = ["--cfg-options"] + [
        f"data.test.{k}={v}" for k, v in (("ann_file", root / "val.json"),
                                          ("img_prefix", root))]
    show_dir = tmp_path / "show"
    monkeypatch.delenv("DISPLAY", raising=False)
    # the package's logger does not propagate: listen on it
    logger = logging.getLogger("pavenet_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        res = test_cli.main([TINY, ckpt, "--device", "cpu", "--out",
                             str(tmp_path / "dets.json"), "--show",
                             "--show-dir", str(show_dir),
                             "--show-score-thr", "0.0"] + opts)
    finally:
        logger.removeHandler(caplog.handler)
    assert any("headless" in r.message for r in caplog.records)
    with open(tmp_path / "dets.json") as f:
        dets = json.load(f)
    with open(root / "val.json") as f:
        infos = {im["id"]: im for im in json.load(f)["images"]}
    by_img = {}
    for d in dets:
        by_img.setdefault(d["image_id"], []).append(d)
    assert res["rendered"] == len(by_img) > 1
    written = sorted(os.path.relpath(os.path.join(d, f), show_dir)
                     for d, _, files in os.walk(show_dir) for f in files)
    assert written == sorted(infos[i]["file_name"] for i in by_img)
    # the scenes' frames are JPEG files: JAX's render written the same way
    # gives the same bytes
    for i, (img_id, img_dets) in enumerate(by_img.items()):
        name = infos[img_id]["file_name"]
        jfile = str(tmp_path / f"jax_{i}.jpg")
        jvis.render_detections(str(root / name), img_dets, score_thr=0.0,
                               out_file=jfile, class_names=("person",))
        with open(show_dir / name, "rb") as got, open(jfile, "rb") as want:
            assert got.read() == want.read(), name


def test_synthetic_loader_matches_jax():
    jtrain = load_jax_script("tools", "train.py")
    head = tconfig.Config.fromfile(FLAGSHIP).model.bbox_head
    for epoch in range(2):
        want = list(jtrain.synthetic_loader(head, 2, 20, seed=7 + epoch))
        got = list(train_cli.synthetic_loader(head, 2, 20, seed=7 + epoch))
        assert len(got) == len(want) == train_cli.SYNTHETIC_STEPS
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # each rank takes its rows of the global batch
    rows = [list(train_cli.synthetic_epoch(
        tconfig.Config.fromfile(FLAGSHIP), 1, 1, 7, rank=r, world=2))[0]
        for r in range(2)]
    whole = next(iter(jtrain.synthetic_loader(head, 2, 1, seed=8)))
    for k in whole:
        np.testing.assert_array_equal(
            np.concatenate([r[k] for r in rows]), whole[k])


def test_synthetic_train_writes_a_profile(tmp_path, monkeypatch):
    validated = []
    monkeypatch.setattr(train_cli, "evaluate_epoch",
                        lambda *a, **k: validated.append(a))
    sys.modules.setdefault("tensorflow", None)
    res = train_cli.main([TINY, "--synthetic", "--max-steps", "4",
                          "--profile-dir", str(tmp_path / "prof"),
                          "--work-dir", str(tmp_path / "work"),
                          "--device", "cpu"])
    assert res["steps"] == 4 and validated == []
    assert all(math.isfinite(v) for v in res["losses"].values())
    assert res["profile_trace"].startswith(str(tmp_path / "prof"))
    with open(res["profile_trace"]) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("mini_step_"))
    assert steps == ["mini_step_3", "mini_step_4"]
    assert res["profiled_step_ms"] > 0 and res["step_ms"] > 0


def test_keypoint2pseudo_box_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    anns = []
    for i in range(12):
        k = np.concatenate([rng.rand(17, 2) * 500, rng.randint(0, 3, (17, 1))],
                           1)
        if i == 3:
            k[:, 2] = 0   # nothing visible: bbox kept
        anns.append(dict(id=i, image_id=i // 3, keypoints=k.reshape(-1)
                         .tolist(), bbox=[1.0, 2.0, 3.0, 4.0], area=12.0))
    anns.append(dict(id=99, image_id=0, bbox=[0, 0, 1, 1]))  # no keypoints
    src = tmp_path / "in.json"
    src.write_text(json.dumps(dict(images=[], annotations=anns)))
    jscript = load_jax_script("tools", "dataset_converters",
                              "keypoint2pseudo_box.py")
    monkeypatch.setattr(sys, "argv", ["x", str(src), str(tmp_path / "j.json"),
                                      "--margin", "0.15"])
    jscript.main()
    n = keypoint2pseudo_box.main([str(src), str(tmp_path / "t.json"),
                                  "--margin", "0.15"])
    assert n == 11
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("config", [
    "configs/videopose/pavenet_tiny_debug.py",
    "configs/petr/petr_r50_16x2_100e_coco.py",
    "configs/dk-detr/dkd_r50_70e_lvis.py"])
def test_config_text_matches_jax(config):
    path = os.path.join(REPO, config)
    got, want = tconfig.Config.fromfile(path), jconfig.Config.fromfile(path)
    assert got.pretty_text == want.pretty_text
    assert got.dump() == want.dump()
    again = tconfig.Config.fromstring(got.dump())
    assert again.to_dict() == jconfig.Config.fromstring(
        want.dump()).to_dict() == want.to_dict()
    assert tconfig.pformat_value(got.to_dict()["model"]) == \
        jconfig.pformat_value(want.to_dict()["model"])
    dup = copy.deepcopy(got)
    assert type(dup) is tconfig.Config and dup == got
    assert type(dup.model) is tconfig.ConfigDict
    dup.model.type = "changed"
    assert got.model.type != "changed"


def test_registry_matches_jax():
    for key in ("opera.PETR", "mmdet.ResNet", "torch.nn.Linear", "PETR",
                "other.Thing", "mmcv.cnn.Conv"):
        assert tregistry.split_scope_key(key) == jregistry.split_scope_key(
            key)
    reg = tregistry.Registry("things")

    @reg.register_module()
    class Thing:
        def __init__(self, a, b=2):
            self.a, self.b = a, b

    made = tregistry.build_from_cfg(dict(type="opera.Thing", a=1), reg,
                                    dict(b=5, a=9))
    assert (made.a, made.b) == (1, 5)
    made = reg.build(dict(type=Thing, a=3))
    assert (made.a, made.b) == (3, 2)
    with pytest.raises(KeyError):
        reg.build(dict(type="Nothing"))
    with pytest.raises(TypeError):
        tregistry.build_from_cfg(dict(a=1), reg)


def test_rle_cost_matches_jax():
    rng = np.random.RandomState(0)
    jflow = JRealNVP()
    variables = jax.jit(jflow.init)(jax.random.PRNGKey(0),
                                    np.zeros((1, 2), np.float32))
    variables = jax.tree.map(lambda x: np.asarray(x) + rng.randn(
        *x.shape).astype(np.float32) * 0.05, variables)
    flow = RealNVP()
    flow.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    Q, G, K = 12, 4, 15
    gt = rng.rand(G, K, 2).astype(np.float32)
    pred = rng.rand(Q, K, 2).astype(np.float32)
    pred[0] = gt[0]
    sigma = (rng.rand(Q, K, 2) * 0.2 + 0.02).astype(np.float32)
    vis = (rng.rand(G, K) > 0.3).astype(np.float32)
    vis[3] = 0.0                                   # a gt with no joint
    want = np.asarray(jassigner.rle_cost(
        pred, sigma, gt, vis,
        lambda x: jflow.apply(variables, x, method="log_prob")))
    got = tassigner.rle_cost(*(torch.from_numpy(a) for a in (
        pred, sigma, gt, vis)), flow.log_prob).detach().numpy()
    assert got.shape == (Q, G)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pose_hungarian_assign_matches_jax():
    rng = np.random.RandomState(5)
    Q, G, K = 30, 6, 15
    h, w = 96.0, 128.0
    for case in range(3):
        cls = rng.randn(Q, 1).astype(np.float32)
        kpt = rng.rand(Q, K, 2).astype(np.float32)
        gt = np.concatenate([rng.rand(G, K, 1) * w, rng.rand(G, K, 1) * h,
                             (rng.rand(G, K, 1) > 0.3)], -1).astype(np.float32)
        areas = (rng.rand(G) * 3e3 + 100).astype(np.float32)
        valid = rng.rand(G) > 0.3 * case
        shape = np.array([h, w], np.int32)
        want = jassigner.pose_hungarian_assign(cls, kpt, gt, areas, valid,
                                               shape)
        got = tassigner.pose_hungarian_assign(*(torch.from_numpy(a) for a in (
            cls, kpt, gt, areas, valid, shape)))
        np.testing.assert_array_equal(got.query_idx.numpy(),
                                      np.asarray(want.query_idx))
        np.testing.assert_array_equal(got.valid.numpy(), valid)


def test_step_lr_schedule_matches_jax():
    for base, spe, epochs, gamma in ((2e-4, 100, (8, 11), 0.1),
                                     (1.0, 7, (1.5, 3), 0.5)):
        want = j_step_lr_schedule(base, spe, epochs, gamma)
        got = step_lr_schedule(base, spe, epochs, gamma)
        for b in sorted({int(e * spe) for e in epochs}) + [0]:
            for t in (b - 1, b, b + 1):
                if t >= 0:
                    assert got(t) == pytest.approx(float(want(t)), rel=1e-6)


def test_sine_positional_encoding_class_matches_jax():
    mask = np.zeros((2, 9, 13), bool)
    mask[0, 7:] = True
    mask[1, :, 10:] = True
    for kw in (dict(num_feats=16), dict(num_feats=8, temperature=20,
                                        normalize=False, offset=0.0)):
        want = np.asarray(JSinePositionalEncoding(**kw)(jnp.asarray(mask)))
        got = SinePositionalEncoding(**kw)(torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * max(
            1.0, np.abs(want).max()))
