"""Datasets of other families (as ``pavenet_tpu/datasets/extra.py``):
CrowdPose (14 keypoints, evaluated by the CrowdPose protocol), single-frame
PoseTrack (15 keypoints, only labelled frames), and the detection data of
SOIT and DK-DETR: COCO instances (also ``CocoDataset``), Objects365, LVIS
v1 with its federated evaluation, the class-balanced repeat wrapper, and
Pascal VOC from XML with its mAP. The detection datasets carry no
keypoints (K=0); ``evaluate_detections``, where a dataset has it, is its
own protocol."""
from __future__ import annotations

import math
import os.path as osp
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..registry import DATASETS
from ..utils.seed import Generators
from .coco_pose import CocoPoseDataset
from .posetrack import POSETRACK_FLIP_PAIRS


@DATASETS.register_module()
class CrowdPoseDataset(CocoPoseDataset):
    CLASSES = ("person",)
    NUM_KEYPOINTS = 14
    FLIP_PAIRS = ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11))
    # xtcocotools' 'keypoints_crowd': OKS without the area term and the
    # crowd-index bands AP(E), AP(M), AP(H)
    EVAL_PROTOCOL = "crowdpose"


@DATASETS.register_module()
class PosetrackPoseDataset(CocoPoseDataset):
    CLASSES = ("person",)
    NUM_KEYPOINTS = 15
    FLIP_PAIRS = POSETRACK_FLIP_PAIRS
    EVAL_PROTOCOL = "posetrack"

    def _load_infos(self):
        """The labelled frames (``is_labeled``), each with a person in
        training."""
        return [info for info in super()._load_infos()
                if info.get("is_labeled", True)]


@DATASETS.register_module(name=["CocoInstanceDataset", "CocoDataset"])
class CocoInstanceDataset(CocoPoseDataset):
    """COCO instances for SOIT and DK-DETR: every category, labels in
    sorted category-id order, boxes and raw polygon segmentations; no
    keypoints (K=0). Every image with a non-crowd annotation in training."""
    CLASSES = None
    NUM_KEYPOINTS = 0

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("min_keypoints", 0)
        super().__init__(*args, **kwargs)

    def get_ann(self, idx) -> dict:
        info = self.data_infos[idx]
        boxes, labels, areas, segs = [], [], [], []
        cat2label = {c: i for i, c in enumerate(sorted(
            self.coco.get_cat_ids()))}
        for ann in self.coco.img_to_anns[info["id"]]:
            if ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann.get("bbox", [0, 0, 0, 0])
            boxes.append([x, y, x + w, y + h])
            labels.append(cat2label[ann["category_id"]])
            areas.append(ann.get("area", w * h))
            segs.append(ann.get("segmentation"))
        return dict(
            keypoints=np.zeros((len(boxes), 0, 3), np.float32),
            areas=np.asarray(areas, np.float32),
            bboxes=(np.asarray(boxes, np.float32) if boxes
                    else np.zeros((0, 4), np.float32)),
            labels=np.asarray(labels, np.int64),
            segmentations=segs,
        )


@DATASETS.register_module()
class Objects365Dataset(CocoPoseDataset):
    """Objects365 boxes (labels = category id - 1), no keypoints."""
    NUM_KEYPOINTS = 0

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("min_keypoints", 0)
        super().__init__(*args, **kwargs)

    def get_ann(self, idx) -> dict:
        info = self.data_infos[idx]
        boxes, labels, areas = [], [], []
        for ann in self.coco.img_to_anns[info["id"]]:
            if ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann.get("bbox", [0, 0, 0, 0])
            boxes.append([x, y, x + w, y + h])
            labels.append(ann.get("category_id", 1) - 1)
            areas.append(ann.get("area", w * h))
        return dict(
            keypoints=np.zeros((len(boxes), 0, 3), np.float32),
            areas=np.asarray(areas, np.float32),
            bboxes=(np.asarray(boxes, np.float32) if boxes
                    else np.zeros((0, 4), np.float32)),
            labels=np.asarray(labels, np.int64),
        )


@DATASETS.register_module(name=["LVISV1Dataset", "LVISDataset"])
class LVISV1Dataset(CocoInstanceDataset):
    """LVIS v1 instances: an image's ``file_name`` derives from its
    ``coco_url`` (``<split>/<name>.jpg``) where missing; in training the
    images with an annotation; evaluated by the LVIS federated protocol."""

    def _load_infos(self):
        infos = []
        for img_id in self.coco.get_img_ids():
            info = dict(self.coco.load_imgs([img_id])[0])
            if "file_name" not in info and "coco_url" in info:
                info["file_name"] = "/".join(
                    info["coco_url"].split("/")[-2:])
            if self.test_mode or self.coco.img_to_anns.get(info["id"]):
                infos.append(info)
        return infos

    def get_cat_ids(self, idx) -> list:
        info = self.data_infos[idx]
        return [a["category_id"]
                for a in self.coco.img_to_anns.get(info["id"], [])]

    def evaluate_detections(self, detections, metrics=None):
        """``bbox/...`` and, where the detections carry masks,
        ``segm/...`` by ``LVISDetEval`` (maxDets 300, APr/APc/APf)."""
        from ..core.eval.lvis_eval import LVISDetEval
        if metrics is None:
            metrics = (("bbox", "segm")
                       if detections and "segmentation" in detections[0]
                       else ("bbox",))
        results = OrderedDict()
        dt = self.coco.load_res(detections)
        for metric in metrics:
            res = LVISDetEval(self.coco, dt, iou_type=metric).evaluate()
            results.update({f"{metric}/{k}": v for k, v in res.items()})
        return results


@DATASETS.register_module()
class ClassBalancedDataset:
    """Repeat-factor oversampling (mmdet ``ClassBalancedDataset``, the
    LVIS paper's): a category of image frequency f repeats r(c) = max(1,
    sqrt(thr / f)), an image ceil(max over its categories of r(c)) times."""

    def __init__(self, dataset, oversample_thr: float,
                 filter_empty_gt: bool = True, **kwargs):
        if isinstance(dataset, dict):
            dataset = DATASETS.build(dataset)
        self.dataset = dataset
        self.oversample_thr = oversample_thr
        self.CLASSES = dataset.CLASSES
        self.NUM_KEYPOINTS = getattr(dataset, "NUM_KEYPOINTS", 0)
        self.EVAL_PROTOCOL = getattr(dataset, "EVAL_PROTOCOL", "coco")
        self.num_frames = getattr(dataset, "num_frames", 1)
        n = len(dataset)
        freq, per_img_cats = {}, []
        for i in range(n):
            cats = set(dataset.get_cat_ids(i))
            if not cats and not filter_empty_gt:
                cats = {-1}
            per_img_cats.append(cats)
            for c in cats:
                freq[c] = freq.get(c, 0) + 1
        repeat = {c: max(1.0, math.sqrt(oversample_thr / (v / n)))
                  for c, v in freq.items()}
        self.repeat_indices = []
        for i, cats in enumerate(per_img_cats):
            r = max((repeat[c] for c in cats), default=1.0)
            self.repeat_indices.extend([i] * math.ceil(r))

    @property
    def coco(self):
        return self.dataset.coco

    def __len__(self):
        return len(self.repeat_indices)

    def prepare(self, idx, rng: Optional[Generators] = None):
        return self.dataset.prepare(self.repeat_indices[idx], rng)

    def __getitem__(self, idx):
        return self.prepare(idx)

    def get_ann(self, idx) -> dict:
        return self.dataset.get_ann(self.repeat_indices[idx])


@DATASETS.register_module()
class VOCDataset:
    """Pascal VOC boxes from XML: ``ann_file`` is an ImageSets split list,
    annotations under ``img_prefix/Annotations``, boxes moved from 1-based
    inclusive to 0-based, ``difficult`` kept; evaluated by VOC mAP (the
    11-point metric for VOC2007)."""
    CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")
    NUM_KEYPOINTS = 0
    EVAL_PROTOCOL = "voc"
    num_frames = 1

    def __init__(self, ann_file: str, img_prefix: str = "", pipeline=None,
                 test_mode: bool = False, **kwargs):
        self.img_prefix = img_prefix
        self.pipeline = pipeline
        self.test_mode = test_mode
        self.year = 2007 if "VOC2007" in (img_prefix or ann_file) else 2012
        with open(ann_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.data_infos = [
            dict(id=i, stem=s,
                 file_name=osp.join("JPEGImages", s + ".jpg"),
                 xml=osp.join(img_prefix, "Annotations", s + ".xml"))
            for i, s in enumerate(self.ids)]

    def __len__(self):
        return len(self.data_infos)

    def get_ann(self, idx) -> dict:
        import xml.etree.ElementTree as ET
        info = self.data_infos[idx]
        cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        boxes, labels, difficult = [], [], []
        for obj in ET.parse(info["xml"]).getroot().findall("object"):
            name = obj.find("name").text
            if name not in cat2label:
                continue
            bnd = obj.find("bndbox")
            boxes.append([float(bnd.find(k).text) - 1
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            labels.append(cat2label[name])
            diff = obj.find("difficult")
            difficult.append(int(diff.text) if diff is not None else 0)
        boxes = (np.asarray(boxes, np.float32) if boxes
                 else np.zeros((0, 4), np.float32))
        return dict(
            keypoints=np.zeros((len(boxes), 0, 3), np.float32),
            areas=((boxes[:, 2] - boxes[:, 0])
                   * (boxes[:, 3] - boxes[:, 1])),
            bboxes=boxes,
            labels=np.asarray(labels, np.int64),
            difficult=np.asarray(difficult, bool),
        )

    def prepare(self, idx, rng: Optional[Generators] = None) -> dict:
        info = self.data_infos[idx]
        ann = self.get_ann(idx)
        results = dict(
            img_info=info, image_id=info["id"],
            frame_files=[osp.join(self.img_prefix, info["file_name"])],
            gt_bboxes=ann["bboxes"], gt_labels=ann["labels"],
            gt_areas=ann["areas"], gt_keypoints=ann["keypoints"])
        if self.pipeline is not None:
            results = self.pipeline(results, rng)
        return results

    def __getitem__(self, idx) -> dict:
        return self.prepare(idx)

    def evaluate_detections(self, detections, iou_thr=(0.5,)):
        """``mAP<thr>`` at each IoU threshold of the detections (``image_id``
        the image's index, ``bbox`` xywh, ``category_id`` label + 1)."""
        from ..core.eval.voc_eval import eval_voc_map
        gts = [self.get_ann(i) for i in range(len(self))]
        results = OrderedDict()
        if not isinstance(iou_thr, (list, tuple)):
            iou_thr = [iou_thr]
        for thr in iou_thr:
            results[f"mAP{int(thr * 100)}"] = eval_voc_map(
                gts, detections, num_classes=len(self.CLASSES),
                iou_thr=thr, use_07_metric=self.year == 2007)
        return results
