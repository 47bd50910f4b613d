"""The port's detection data, evaluators, text encoders and test CLI
against the JAX package's, on the CPU.

A seeded COCO-format instance json (four images at 96x128 and 80x120,
three categories with ids 1, 3 and 7, polygon ``segmentation``s, a crowd,
an image with nothing; an LVIS variant with ``coco_url``, category
``frequency`` and the federated image fields) and a VOC2007 tree of XML
files (difficult objects, a class outside VOC's).

- ``CocoInstanceDataset`` (also ``CocoDataset``), ``Objects365Dataset``,
  ``LVISV1Dataset``, ``ClassBalancedDataset`` and ``VOCDataset``: the same
  kept images in test and train mode, annotations and items through the
  tiny SOIT config's test pipeline (host-normalised), and ``ClipLoader``
  batches with K=0, exactly.
- ``COCODetEval`` (bbox and segm, masks as arrays and as polygons),
  ``evaluate_dataset``'s detection branch, the LVIS protocol
  (``evaluate_detections``) and VOC mAP at IoU 0.5 and 0.75 (VOC2007's
  11-point metric and the area metric): the same metric dicts as JAX on
  the same seeded detections, exactly.
- ``build_prompts``, ``ensemble_prompt_embeddings``, ``PseudoTextEncoder``
  and ``CLIPTextEncoder`` (a seeded stand-in embedding function): JAX's
  arrays.
- ``tools.test.main --device cpu`` on checkpoints of the tiny SOIT config
  and of a tiny DK-DETR whose text embeddings have fewer rows (3) than its
  ``num_classes`` (5): bbox and segm metrics, ``--out`` without masks, and
  every label within the text rows.
"""
import json
import os
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest

from pavenet_tpu.apis import test as jtest
from pavenet_tpu.core.eval import coco_det_eval as jcoco_det_eval
from pavenet_tpu.core.eval import voc_eval as jvoc_eval
from pavenet_tpu.datasets import extra as jextra
from pavenet_tpu.datasets.loader import ClipLoader as JClipLoader
from pavenet_tpu.datasets.pipelines import transforms as jtf
from pavenet_tpu.models import text_encoder as jtext
from pavenet_tpu_torch import datasets
from pavenet_tpu_torch.apis import test as ttest
from pavenet_tpu_torch.config import Config
from pavenet_tpu_torch.core.eval import coco_det_eval, voc_eval
from pavenet_tpu_torch.datasets.pipelines import transforms as tf
from pavenet_tpu_torch.models import text_encoder
from tests.test_torch_coco_data import same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOIT_TINY = os.path.join(REPO, "configs/soit/soit_tiny_debug.py")
CAT_IDS = (1, 3, 7)
SIZES = ((96, 128), (80, 120), (96, 128), (80, 120))


def write_instances(root, lvis=False, seed=0):
    """The instance json (``lvis``: the LVIS variant) and its images;
    returns the json's path."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        name = f"val2017/{i:012d}.jpg"
        os.makedirs(root / "val2017", exist_ok=True)
        cv2.imwrite(str(root / name),
                    rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        info = dict(id=i + 1, height=h, width=w)
        if lvis:
            info.update(coco_url=f"http://images.cocodataset.org/{name}",
                        neg_category_ids=[CAT_IDS[i % 3]],
                        not_exhaustive_category_ids=[CAT_IDS[(i + 1) % 3]]
                        if i % 2 else [])
        else:
            info["file_name"] = name
        images.append(info)
        if i == 2:     # an image with nothing
            continue
        for p in range(3):
            bw, bh = rng.uniform(15, 50), rng.uniform(15, 40)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            poly = [x0, y0, x0 + bw, y0 + rng.uniform(0, bh / 2),
                    x0 + bw * rng.uniform(0.5, 1), y0 + bh, x0, y0 + bh]
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1,
                category_id=int(CAT_IDS[rng.randint(3)]),
                bbox=[x0, y0, bw, bh], area=bw * bh * 0.8,
                segmentation=[[round(float(v), 2) for v in poly]],
                iscrowd=int(p == 1 and i == 0)))
    cats = [dict(id=c, name=f"cat{c}", frequency="rcf"[j])
            for j, c in enumerate(CAT_IDS)]
    path = root / ("lvis_val.json" if lvis else "instances_val.json")
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return path


def write_voc(root, seed=0):
    """A VOC2007 tree: three images, their XML and the test split."""
    rng = np.random.RandomState(seed)
    voc = root / "VOC2007"
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(voc / d, exist_ok=True)
    names = ("dog", "person", "car", "unicorn")
    stems = []
    for i, (h, w) in enumerate(SIZES[:3]):
        stem = f"{i + 1:06d}"
        stems.append(stem)
        cv2.imwrite(str(voc / "JPEGImages" / f"{stem}.jpg"),
                    rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        ann = ET.Element("annotation")
        for k in range(3):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = names[rng.randint(4)]
            ET.SubElement(obj, "difficult").text = str(int(k == 2))
            box = ET.SubElement(obj, "bndbox")
            x0, y0 = rng.randint(1, w // 2), rng.randint(1, h // 2)
            for tag, v in (("xmin", x0), ("ymin", y0),
                           ("xmax", x0 + rng.randint(10, w // 2)),
                           ("ymax", y0 + rng.randint(10, h // 2))):
                ET.SubElement(box, tag).text = str(v)
        ET.ElementTree(ann).write(voc / "Annotations" / f"{stem}.xml")
    split = voc / "ImageSets/Main/test.txt"
    split.write_text("\n".join(stems) + "\n")
    return split, voc


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    coco = write_instances(root)
    lvis = write_instances(root, lvis=True)
    split, voc = write_voc(root)
    return dict(root=root, coco=coco, lvis=lvis, voc_split=split, voc=voc)


def families(data):
    """(name, JAX class, port class, arguments) of every dataset."""
    coco = dict(ann_file=str(data["coco"]), img_prefix=str(data["root"]) + "/")
    lvis = dict(ann_file=str(data["lvis"]), img_prefix=str(data["root"]) + "/")
    return [("coco", jextra.CocoInstanceDataset, datasets.CocoInstanceDataset,
             coco),
            ("objects365", jextra.Objects365Dataset,
             datasets.Objects365Dataset, coco),
            ("lvis", jextra.LVISV1Dataset, datasets.LVISV1Dataset, lvis),
            ("voc", jextra.VOCDataset, datasets.VOCDataset,
             dict(ann_file=str(data["voc_split"]),
                  img_prefix=str(data["voc"])))]


def test_detection_datasets_match_jax(data):
    kwargs = Config.fromfile(SOIT_TINY)["test_pipeline_kwargs"]
    for name, jcls, cls, args in families(data):
        for test_mode in (True, False):
            jds, ds = jcls(test_mode=test_mode, **args), cls(
                test_mode=test_mode, **args)
            assert len(ds) == len(jds) == {("lvis", False): 3,
                                           ("coco", False): 3,
                                           ("objects365", False): 3}.get(
                                               (name, test_mode), len(ds))
            for i in range(len(ds)):
                same(ds.get_ann(i), jds.get_ann(i), f"{name} ann {i}")
        assert ds.NUM_KEYPOINTS == 0
        jds = jcls(test_mode=True, pipeline=jtf.build_test_pipeline(**kwargs),
                   **args)
        ds = cls(test_mode=True, pipeline=tf.build_test_pipeline(**kwargs),
                 **args)
        for i in range(len(ds)):
            same(ds.prepare(i), jds[i], f"{name} item {i}")
        opts = dict(batch_size=2, shuffle=False, drop_last=False,
                    num_keypoints=0, max_gt=4)
        want = [dict(b) for b in JClipLoader(jds, **opts)]
        got = [dict(b) for b in datasets.ClipLoader(ds, **opts)]
        same(got, want, f"{name} batches")
        assert got[0]["gt_keypoints"].shape == (2, 4, 0, 3)
    assert datasets.CocoInstanceDataset is datasets.extra.DATASETS.get(
        "opera.CocoDataset")
    lvis = dict(families(data)[2][3], type="LVISV1Dataset")
    jw = jextra.ClassBalancedDataset(dict(lvis), oversample_thr=0.9)
    w = datasets.ClassBalancedDataset(dict(lvis), oversample_thr=0.9)
    assert w.repeat_indices == jw.repeat_indices
    assert len(w) > len(w.dataset)
    for i in range(len(w)):
        same(w.get_ann(i), jw.get_ann(i), f"balanced ann {i}")


def seeded_detections(ann, seed=1, masks=None):
    """The json's annotations jittered, with seeded scores and a category
    swap now and then, plus two false positives per image; ``masks``
    'array' adds a binary mask per detection, 'poly' a polygon."""
    rng = np.random.RandomState(seed)
    sizes = {im["id"]: (im["height"], im["width"]) for im in ann["images"]}
    dets = []
    for a in ann["annotations"]:
        x, y, w, h = np.asarray(a["bbox"]) + rng.randn(4) * 2
        cat = (a["category_id"] if rng.rand() > 0.2
               else int(CAT_IDS[rng.randint(3)]))
        dets.append(dict(image_id=a["image_id"], category_id=cat,
                         bbox=[x, y, max(w, 2.0), max(h, 2.0)],
                         score=float(rng.rand())))
    for im in ann["images"]:
        for _ in range(2):
            dets.append(dict(image_id=im["id"],
                             category_id=int(CAT_IDS[rng.randint(3)]),
                             bbox=[*rng.uniform(0, 60, 2),
                                   *rng.uniform(10, 40, 2)],
                             score=float(rng.rand())))
    for d in dets:
        x, y, w, h = d["bbox"]
        poly = [[x, y, x + w, y, x + w * 0.8, y + h, x, y + h]]
        if masks == "poly":
            d["segmentation"] = poly
        elif masks == "array":
            d["segmentation"] = coco_det_eval.polys_to_mask(
                poly, *sizes[d["image_id"]])
    return dets


def test_coco_det_eval_and_evaluate_dataset_match_jax(data):
    ann = json.load(open(data["coco"]))
    ds = datasets.CocoInstanceDataset(ann_file=str(data["coco"]),
                                      test_mode=True)
    jds = jextra.CocoInstanceDataset(ann_file=str(data["coco"]),
                                     test_mode=True)
    poly = ann["annotations"][0]["segmentation"]
    np.testing.assert_array_equal(coco_det_eval.polys_to_mask(poly, 96, 128),
                                  jcoco_det_eval.polys_to_mask(poly, 96, 128))
    for masks in (None, "poly", "array"):
        dets = seeded_detections(ann, masks=masks)
        for iou_type in ("bbox", "segm") if masks else ("bbox",):
            got = coco_det_eval.COCODetEval(
                ds.coco, ds.coco.load_res(dets), iou_type=iou_type).evaluate()
            want = jcoco_det_eval.COCODetEval(
                jds.coco, jds.coco.load_res(dets),
                iou_type=iou_type).evaluate()
            assert got == want, (masks, iou_type)
            assert 0 < got["AP"] < 1
        got = ttest.evaluate_dataset(ds, dets)
        assert got == jtest.evaluate_dataset(jds, dets)
        assert ("segm/AP" in got) == bool(masks) and "bbox/AP50" in got


def test_lvis_and_voc_evaluation_match_jax(data):
    ann = json.load(open(data["lvis"]))
    args = dict(ann_file=str(data["lvis"]), test_mode=True)
    ds, jds = datasets.LVISV1Dataset(**args), jextra.LVISV1Dataset(**args)
    for masks in (None, "array"):
        dets = seeded_detections(ann, seed=2, masks=masks)
        got = ttest.evaluate_dataset(ds, dets)
        assert got == jtest.evaluate_dataset(jds, dets)
        assert {"bbox/AP_r", "bbox/AP_c", "bbox/AP_f"} <= set(got)
        assert ("segm/AP" in got) == bool(masks)
    args = dict(ann_file=str(data["voc_split"]), img_prefix=str(data["voc"]))
    ds, jds = datasets.VOCDataset(**args), jextra.VOCDataset(**args)
    rng = np.random.RandomState(4)
    dets = []
    for i in range(len(ds)):
        a = ds.get_ann(i)
        for b, lab in zip(a["bboxes"], a["labels"]):
            b = b + rng.randn(4) * 3
            dets.append(dict(image_id=i, category_id=int(lab) + 1,
                             bbox=[b[0], b[1], b[2] - b[0], b[3] - b[1]],
                             score=float(rng.rand())))
        dets.append(dict(image_id=i, category_id=int(rng.randint(1, 21)),
                         bbox=[5.0, 5.0, 30.0, 20.0], score=0.5))
    thr = (0.5, 0.75)
    got = ds.evaluate_detections(dets, iou_thr=thr)
    assert got == jds.evaluate_detections(dets, iou_thr=thr)
    assert set(got) == {"mAP50", "mAP75"} and got["mAP50"] > 0
    assert ttest.evaluate_dataset(ds, dets) == jtest.evaluate_dataset(jds,
                                                                      dets)
    gts = [ds.get_ann(i) for i in range(len(ds))]
    for use_07 in (True, False):
        assert voc_eval.eval_voc_map(gts, dets, 20, 0.5, use_07) == \
            jvoc_eval.eval_voc_map(gts, dets, 20, 0.5, use_07)


def test_text_encoders_match_jax(tmp_path):
    names = ["cat", "stop sign", "zebra"]
    templates = ("a photo of a {}.", "itap of my {}.")
    assert (text_encoder.build_prompts(names, templates)
            == jtext.build_prompts(names, templates))
    assert text_encoder.VILD_TEMPLATES == jtext.VILD_TEMPLATES
    rng = np.random.RandomState(5)
    emb = rng.randn(len(templates) * 3, 8).astype(np.float32)
    np.testing.assert_array_equal(
        text_encoder.ensemble_prompt_embeddings(emb, 2, 3),
        jtext.ensemble_prompt_embeddings(emb, 2, 3))
    table = {p: rng.randn(8) for p in text_encoder.build_prompts(
        names, text_encoder.VILD_TEMPLATES)}

    def embed(prompts):
        return np.stack([table[p] for p in prompts])

    np.testing.assert_array_equal(
        text_encoder.CLIPTextEncoder(names, embed).get_text_feat(),
        jtext.CLIPTextEncoder(names, text_dim=8,
                              embed_fn=embed).get_text_feat())
    path = tmp_path / "text.npy"
    np.save(path, emb)
    got = text_encoder.PseudoTextEncoder(str(path), 8).get_text_feat()
    np.testing.assert_array_equal(
        got, jtext.PseudoTextEncoder(str(path), 8).get_text_feat())
    with pytest.raises(ValueError, match="expected"):
        text_encoder.PseudoTextEncoder(str(path), 16).get_text_feat()


def test_test_cli_on_tiny_soit_and_dkdetr(data, tmp_path):
    """``tools.test.main --device cpu`` on a seeded-init checkpoint of the
    tiny SOIT config, and of a tiny DK-DETR (the LVIS config at SOIT tiny's
    sizes, five classes) with three text rows."""
    import torch
    from pavenet_tpu_torch.apis import init_trainer
    from pavenet_tpu_torch.tools import test as test_cli
    from pavenet_tpu_torch.utils.checkpoint import save_checkpoint
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dk_cfg = tmp_path / "dk_tiny.py"
    np.save(tmp_path / "text.npy",
            np.random.RandomState(6).randn(3, 16).astype(np.float32))
    base = os.path.join(REPO, "configs/dk-detr/dkd_r50_70e_test_coco.py")
    dk_cfg.write_text(
        f"_base_ = {base!r}\n"
        "model = dict(backbone=dict(depth=18), neck=dict(in_channels=[128, "
        "256, 512], out_channels=32), bbox_head=dict(num_query=12, "
        "num_classes=5, max_gt=4, transformer=dict(encoder=dict(num_layers="
        "1, transformerlayers=dict(attn_cfgs=dict(embed_dims=32), "
        "feedforward_channels=64)), decoder=dict(num_layers=2))), "
        "text_encoder=dict(text_dim=16, text_feat_path="
        f"{str(tmp_path / 'text.npy')!r}), test_cfg=dict(max_per_img=6, "
        "score_thr=0.0))\n"
        "test_pipeline_kwargs = dict(img_scale=(96, 64), "
        "buckets=((96, 128),))\n")
    opts = ["--cfg-options", f"data.test.ann_file={data['coco']}",
            f"data.test.img_prefix={data['root']}/"]
    try:
        for config in (SOIT_TINY, str(dk_cfg)):
            state = init_trainer(config, device="cpu", seed=0)
            ckpt = save_checkpoint(str(tmp_path / "work"), state, 1)
            out = tmp_path / "dets.json"
            res = test_cli.main([config, ckpt, "--device", "cpu", "--out",
                                 str(out)] + opts)
            assert {"bbox/AP", "segm/AP", "bbox/AP_L"} <= set(res["metrics"])
            dumped = json.load(open(out))
            assert res["clips"] == 4 and len(dumped) == res["detections"] > 0
            assert "segmentation" not in dumped[0]
            labels = {d["category_id"] for d in dumped}
            assert labels <= set(range(1, 4 if config == str(dk_cfg) else 6))
    finally:
        torch.set_num_threads(n)
