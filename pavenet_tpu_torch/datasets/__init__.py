"""Host-side data of the port: COCO-style index, the PoseTrack video
dataset (registered in ``registry.DATASETS``), the synthetic scene
generator, the pipelines and the batch loader."""
from .coco_api import COCO
from .loader import ClipLoader, pad_gt
from .posetrack import PosetrackVideoPoseDataset

__all__ = ["COCO", "ClipLoader", "PosetrackVideoPoseDataset", "pad_gt"]
