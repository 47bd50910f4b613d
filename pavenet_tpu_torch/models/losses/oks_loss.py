"""OKS loss (as ``pavenet_tpu/models/losses/oks_loss.py``): per-keypoint
sigmas (float32, already divided by 10) for COCO (K=17), PoseTrack (15)
and CrowdPose (14), ``oks_overlaps`` of matched pairs and ``oks_loss``,
-log(OKS) per instance, weighted and averaged."""
from __future__ import annotations

import numpy as np
import torch

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


def oks_overlaps(kpt_preds, kpt_gts, kpt_valids, kpt_areas, sigmas):
    """OKS of matched pairs: ``kpt_preds``/``kpt_gts`` (n, K*2) in pixels,
    ``kpt_valids`` (n, K), ``kpt_areas`` (n,); returns (n,)."""
    sigmas = torch.as_tensor(sigmas, dtype=kpt_preds.dtype,
                             device=kpt_preds.device)
    variances = (sigmas * 2) ** 2
    preds = kpt_preds.unflatten(-1, (-1, 2))
    gts = kpt_gts.unflatten(-1, (-1, 2))
    d2 = ((preds[..., 0] - gts[..., 0]) ** 2
          + (preds[..., 1] - gts[..., 1]) ** 2)
    e = d2 / (kpt_areas[:, None] * variances[None, :] * 2 + 1e-12)
    return ((torch.exp(-e) * kpt_valids).sum(-1)
            / kpt_valids.sum(-1).clamp(min=1e-6))


def oks_loss(kpt_preds, kpt_gts, kpt_valids, kpt_areas,
             num_keypoints: int = 15, linear: bool = False,
             eps: float = 1e-6, weight=None, avg_factor=1.0):
    """-log(OKS) (``linear``: 1 - OKS) per instance, OKS clipped at
    ``eps``; ``weight`` (n,) masks padded instances; the sum over
    ``avg_factor``."""
    oks = oks_overlaps(kpt_preds, kpt_gts, kpt_valids, kpt_areas,
                       OKS_SIGMAS[num_keypoints]).clamp(min=eps)
    loss = (1 - oks) if linear else -torch.log(oks)
    if weight is not None:
        loss = loss * weight
    return loss.sum() / avg_factor
