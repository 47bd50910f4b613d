from .coco_det_eval import COCODetEval, polys_to_mask
from .coco_keypoint_eval import COCOKeypointEval, CrowdPoseKeypointEval
from .lvis_eval import LVISDetEval
from .posetrack_eval import evaluate_posetrack_ap, frames_from_coco
from .posetrack_track_eval import MotAccumulator, evaluate_posetrack_mota
from .voc_eval import eval_voc_map

__all__ = ["COCODetEval", "COCOKeypointEval", "CrowdPoseKeypointEval",
           "LVISDetEval", "MotAccumulator", "eval_voc_map",
           "evaluate_posetrack_ap", "evaluate_posetrack_mota",
           "frames_from_coco", "polys_to_mask"]
