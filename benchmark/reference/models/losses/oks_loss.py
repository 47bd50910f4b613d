"""The OKS per-keypoint sigmas (as ``pavenet_tpu/models/losses/
oks_loss.py``; float32, already divided by 10) for COCO (K=17), PoseTrack
(15) and CrowdPose (14): the matching's OKS cost and OKS-NMS use them."""
from __future__ import annotations

import numpy as np

_SIGMAS = {
    17: (.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
         .87, .87, .89, .89),
    15: (.26, .79, .79, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87,
         .89, .89),
    14: (.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89, .79,
         .79),
}
OKS_SIGMAS = {k: np.asarray(s, np.float32) / np.float32(10.0)
              for k, s in _SIGMAS.items()}
