from .coco_keypoint_eval import COCOKeypointEval, CrowdPoseKeypointEval
from .posetrack_eval import evaluate_posetrack_ap, frames_from_coco
from .posetrack_track_eval import MotAccumulator, evaluate_posetrack_mota

__all__ = ["COCOKeypointEval", "CrowdPoseKeypointEval", "MotAccumulator",
           "evaluate_posetrack_ap", "evaluate_posetrack_mota",
           "frames_from_coco"]
