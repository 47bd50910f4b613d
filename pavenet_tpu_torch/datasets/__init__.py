"""Host-side data of the port: COCO-style index, the PoseTrack video
dataset, the COCO, CrowdPose and single-frame PoseTrack keypoint datasets,
the COCO instance, Objects365, LVIS v1 and VOC detection datasets with the
class-balanced wrapper (registered in ``registry.DATASETS``), the synthetic
scene generator, the pipelines and the batch loader."""
from .coco_api import COCO
from .coco_pose import CocoPoseDataset, CocoVideoPoseDataset
from .extra import (ClassBalancedDataset, CocoInstanceDataset,
                    CrowdPoseDataset, LVISV1Dataset, Objects365Dataset,
                    PosetrackPoseDataset, VOCDataset)
from .loader import ClipLoader, pad_gt
from .posetrack import PosetrackVideoPoseDataset

__all__ = ["COCO", "ClassBalancedDataset", "ClipLoader",
           "CocoInstanceDataset", "CocoPoseDataset", "CocoVideoPoseDataset",
           "CrowdPoseDataset", "LVISV1Dataset", "Objects365Dataset",
           "PosetrackPoseDataset", "PosetrackVideoPoseDataset", "VOCDataset",
           "pad_gt"]
