"""Host-side data of the port: COCO-style index, the PoseTrack video
dataset, the COCO, CrowdPose and single-frame PoseTrack keypoint datasets
(registered in ``registry.DATASETS``), the synthetic scene generator, the
pipelines and the batch loader."""
from .coco_api import COCO
from .coco_pose import CocoPoseDataset, CocoVideoPoseDataset
from .extra import CrowdPoseDataset, PosetrackPoseDataset
from .loader import ClipLoader, pad_gt
from .posetrack import PosetrackVideoPoseDataset

__all__ = ["COCO", "ClipLoader", "CocoPoseDataset", "CocoVideoPoseDataset",
           "CrowdPoseDataset", "PosetrackPoseDataset",
           "PosetrackVideoPoseDataset", "pad_gt"]
