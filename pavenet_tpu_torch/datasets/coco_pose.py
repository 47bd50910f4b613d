"""COCO keypoint datasets (as ``pavenet_tpu/datasets/coco_pose.py``):
``CocoPoseDataset``, 17-keypoint single frames (PETR's stage 1), and
``CocoVideoPoseDataset`` (also ``CocoVideoPoseDatasetV2``), one image
replicated into a T-frame clip for video pretraining (stage 2). Items carry
``gt_bboxes`` (xyxy) for the PETR heatmap target's radius."""
from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from ..registry import DATASETS
from ..utils.seed import Generators
from .coco_api import COCO

COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16))


@DATASETS.register_module()
class CocoPoseDataset:
    CLASSES = ("person",)
    FLIP_PAIRS = COCO_FLIP_PAIRS
    NUM_KEYPOINTS = 17
    # the evaluation protocol of ``apis/test.py::evaluate_dataset``
    EVAL_PROTOCOL = "coco"

    num_frames = 1

    def __init__(self, ann_file: str, img_prefix: str = "", pipeline=None,
                 test_mode: bool = False, min_keypoints: int = 1, **kwargs):
        self.coco = COCO(ann_file)
        self.img_prefix = img_prefix
        self.pipeline = pipeline
        self.test_mode = test_mode
        self.min_keypoints = min_keypoints
        self.data_infos = self._load_infos()

    def _has_person(self, img_id) -> bool:
        return any(a.get("num_keypoints", 0) >= self.min_keypoints
                   and not a.get("iscrowd", 0)
                   for a in self.coco.img_to_anns[img_id])

    def _load_infos(self):
        """Every image in test mode; in training those with a person of at
        least ``min_keypoints`` labelled keypoints."""
        return [dict(self.coco.load_imgs([i])[0])
                for i in self.coco.get_img_ids()
                if self.test_mode or self._has_person(i)]

    def __len__(self):
        return len(self.data_infos)

    def get_ann(self, idx) -> dict:
        """The image's people (crowds and those under ``min_keypoints``
        left out): keypoints (G, K, 3), areas, xyxy boxes and labels."""
        info = self.data_infos[idx]
        kpts, areas, bboxes = [], [], []
        for ann in self.coco.img_to_anns[info["id"]]:
            if ann.get("iscrowd", 0):
                continue
            if ann.get("num_keypoints", 0) < self.min_keypoints:
                continue
            x, y, w, h = ann.get("bbox", [0, 0, 0, 0])
            kpts.append(np.asarray(ann["keypoints"],
                                   np.float32).reshape(-1, 3))
            areas.append(ann.get("area", w * h))
            bboxes.append([x, y, x + w, y + h])
        K = self.NUM_KEYPOINTS
        return dict(
            keypoints=(np.stack(kpts) if kpts
                       else np.zeros((0, K, 3), np.float32)),
            areas=np.asarray(areas, np.float32),
            bboxes=(np.asarray(bboxes, np.float32) if bboxes
                    else np.zeros((0, 4), np.float32)),
            labels=np.zeros((len(kpts),), np.int64),
        )

    def prepare(self, idx, rng: Optional[Generators] = None) -> Optional[dict]:
        """Sample ``idx`` (its image as every frame of the clip) through the
        pipeline, whose random transforms draw from ``rng``; None where the
        pipeline drops it."""
        info = self.data_infos[idx]
        ann = self.get_ann(idx)
        results = dict(
            img_info=info,
            image_id=info["id"],
            frame_files=[osp.join(self.img_prefix, info["file_name"])]
            * self.num_frames,
            gt_keypoints=ann["keypoints"],
            gt_areas=ann["areas"],
            gt_bboxes=ann["bboxes"],
            gt_labels=ann["labels"],
            flip_pairs=self.FLIP_PAIRS,
        )
        if self.pipeline is not None:
            results = self.pipeline(results, rng)
        return results

    def __getitem__(self, idx) -> Optional[dict]:
        return self.prepare(idx)


@DATASETS.register_module(name=["CocoVideoPoseDataset",
                                "CocoVideoPoseDatasetV2"])
class CocoVideoPoseDataset(CocoPoseDataset):
    """Fake-clip COCO: the image stands in for all ``num_frames`` frames."""

    def __init__(self, *args, num_frames: int = 3, **kwargs):
        self.num_frames = num_frames
        super().__init__(*args, **kwargs)
