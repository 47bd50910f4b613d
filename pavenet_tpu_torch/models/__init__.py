from .builder import build_detector
from .detectors import InsPoseDetector, SOITDetector, VideoPoseDetector
from .zoo import (dummy_clip_batch, pavenet_r50_frames3, petr_r50_coco,
                  petr_swinl_coco, soit_r50_coco)

__all__ = ["build_detector", "InsPoseDetector", "SOITDetector",
           "VideoPoseDetector",
           "dummy_clip_batch", "pavenet_r50_frames3", "petr_r50_coco",
           "petr_swinl_coco", "soit_r50_coco"]
