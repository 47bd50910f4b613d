"""COCO-format keypoint datasets of other families (as
``pavenet_tpu/datasets/extra.py``): CrowdPose (14 keypoints, evaluated by
the CrowdPose protocol) and single-frame PoseTrack (15 keypoints, only
labelled frames)."""
from __future__ import annotations

from ..registry import DATASETS
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
