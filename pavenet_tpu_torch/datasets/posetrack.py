"""PoseTrack video pose dataset (as ``pavenet_tpu/datasets/posetrack.py``):
COCO-style json, only ``is_labeled`` frames kept, a clip of ``num_frames``
frames around each labelled frame with the ends clamped to the video.
``first_frame_index`` is 1 for PoseTrack17's file names, 0 for
PoseTrack18's."""
from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np

from ..registry import DATASETS
from .coco_api import COCO
from ..utils.seed import Generators

POSETRACK_KEYPOINTS = (
    "nose", "head_bottom", "head_top", "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow", "left_wrist", "right_wrist", "left_hip",
    "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle")

POSETRACK_FLIP_PAIRS = ((3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14))


@DATASETS.register_module(name=["PosetrackVideoPoseDataset",
                                "PosetrackVideoPoseDatasetV2"])
class PosetrackVideoPoseDataset:
    CLASSES = ("person",)
    FLIP_PAIRS = POSETRACK_FLIP_PAIRS
    NUM_KEYPOINTS = 15
    EVAL_PROTOCOL = "posetrack"

    def __init__(self, ann_file: str, img_prefix: str = "",
                 num_frames: int = 3, pipeline=None, test_mode: bool = False,
                 first_frame_index: int = 1, skip_invalid_pose: bool = True,
                 **kwargs):
        self.coco = COCO(ann_file)
        self.img_prefix = img_prefix
        self.num_frames = num_frames
        self.pipeline = pipeline
        self.test_mode = test_mode
        self.first_frame_index = first_frame_index
        self.skip_invalid_pose = skip_invalid_pose
        self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES)
        self.data_infos = self._load_infos()

    def _load_infos(self) -> List[dict]:
        infos = []
        for img_id in self.coco.get_img_ids():
            info = dict(self.coco.load_imgs([img_id])[0])
            if not info.get("is_labeled", True):
                continue
            info["frame_files"] = self._clip_frames(info)
            infos.append(info)
        return infos

    def _clip_frames(self, info) -> List[str]:
        """The clip's file names, previous to next, clamped to the video."""
        path = info["file_name"]
        stem = osp.basename(path).replace(".jpg", "")
        zfill = len(stem)
        cur = int(stem)
        first = self.first_frame_index
        last = info.get("nframes", cur) - 1 + first
        half = self.num_frames // 2
        frames = []
        for d in range(-half, half + 1):
            idx = min(max(cur + d, first), last)
            frames.append(osp.join(osp.dirname(path),
                                   str(idx).zfill(zfill) + ".jpg"))
        return frames

    def __len__(self):
        return len(self.data_infos)

    def get_ann(self, idx) -> dict:
        """The labelled frame's people: keypoints (G, K, 3), areas, xyxy
        boxes and labels; crowds, people without keypoints and (with
        ``skip_invalid_pose``) without a visible one are left out."""
        info = self.data_infos[idx]
        kpts, areas, bboxes = [], [], []
        for ann in self.coco.img_to_anns[info["id"]]:
            if ann.get("iscrowd", 0) or ann.get("num_keypoints", 1) == 0:
                continue
            k = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
            if self.skip_invalid_pose and (k[:, 2] > 0).sum() == 0:
                continue
            x, y, w, h = ann.get("bbox", [0, 0, 0, 0])
            area = ann.get("area", None)
            if not area:
                vis = k[:, 2] > 0
                if vis.any():
                    area = float((k[vis, 0].max() - k[vis, 0].min())
                                 * (k[vis, 1].max() - k[vis, 1].min()))
                else:
                    area = w * h
            kpts.append(k)
            areas.append(area)
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
        """Sample ``idx`` through the pipeline, whose random transforms draw
        from ``rng``; None where the pipeline drops it."""
        info = self.data_infos[idx]
        ann = self.get_ann(idx)
        results = dict(
            img_info=info,
            image_id=info["id"],
            frame_files=[osp.join(self.img_prefix, f)
                         for f in info["frame_files"]],
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
