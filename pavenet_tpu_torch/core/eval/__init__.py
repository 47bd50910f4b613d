from .coco_keypoint_eval import COCOKeypointEval, CrowdPoseKeypointEval
from .posetrack_eval import evaluate_posetrack_ap, frames_from_coco

__all__ = ["COCOKeypointEval", "CrowdPoseKeypointEval",
           "evaluate_posetrack_ap", "frames_from_coco"]
