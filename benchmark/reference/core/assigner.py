"""Pose Hungarian matching and training targets (as ``pavenet_tpu/core/
assigner.py``), batched over images.

The cost matrices are built on the device, detached, and cross to the host
in one copy per train step; ``ops/lap.py`` solves each image's padded
``(G, Q)`` matrix with scipy, the matrix the JAX package solves on its
device.

GT layout (static shapes): ``gt_kpts (B, G, K, 3)`` unnormalised xyv,
``gt_areas (B, G)``, ``gt_valid (B, G)`` bool; padded rows are invalid.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..ops.lap import hungarian_masked


def _factor(img_shape, dtype=torch.float32):
    """(B, 2) (h, w) -> (B, 1, 1, 2) (w, h) in ``dtype``."""
    return img_shape.flip(-1).to(dtype)[:, None, None, :]


def focal_cls_cost(cls_logits, gamma=2.0, alpha=0.25, eps=1e-12,
                   weight=2.0):
    """mmdet FocalLossCost of the single class: (B, Q, 1) -> (B, Q)."""
    p = torch.sigmoid(cls_logits[..., 0])
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return (pos - neg) * weight


def kpt_l1_cost(kpt_pred, gt_kpts_norm, vis, weight=70.0):
    """Visibility-masked L1: kpt_pred (B, Q, K, 2) normalised, gt (B, G, K,
    2), vis (B, G, K) -> (B, Q, G). Predictions at invisible joints are
    zeroed and compared with the raw gt, as the reference does."""
    visf = (vis > 0).to(kpt_pred.dtype)
    pred = kpt_pred[:, :, None] * visf[:, None, :, :, None]   # (B,Q,G,K,2)
    cost = (pred - gt_kpts_norm[:, None]).abs().sum((-1, -2))
    avg = (visf.sum(-1) * 2.0).clamp(min=1.0)                 # (B, G)
    return cost / avg[:, None, :] * weight


def oks_cost(kpt_pred_abs, gt_kpts_abs, vis, areas, sigmas, weight=7.0):
    """-OKS: kpt_pred_abs (B, Q, K, 2), gt (B, G, K, 2), vis (B, G, K),
    areas (B, G), sigmas (K,) -> (B, Q, G)."""
    variances = (sigmas * 2) ** 2
    d2 = ((kpt_pred_abs[:, :, None, :, 0] - gt_kpts_abs[:, None, :, :, 0]) ** 2
          + (kpt_pred_abs[:, :, None, :, 1]
             - gt_kpts_abs[:, None, :, :, 1]) ** 2)        # (B, Q, G, K)
    e = d2 / (areas.clamp(min=1e-6)[:, None, :, None] * variances * 2)
    visf = (vis > 0).to(e.dtype)
    oks = (torch.exp(-e) * visf[:, None]).sum(-1) / visf.sum(-1).clamp(
        min=1.0)[:, None]
    return -oks * weight


def pose_match_cost(cls_logits, kpt_pred, gt_kpts, gt_areas, img_shape,
                    sigmas, cls_weight=2.0, kpt_weight=70.0,
                    oks_weight=7.0):
    """(B, Q, G) cost = focal + keypoint L1 + (-OKS); non-finite -> 1e4.
    kpt_pred (B, Q, K, 2) normalised; gt_kpts (B, G, K, 3) unnormalised;
    img_shape (B, 2) = (h, w). In the predictions' dtypes, as the JAX
    costs (the image size in the keypoints' dtype)."""
    factor = _factor(img_shape, kpt_pred.dtype)
    gt_xy = gt_kpts[..., :2]
    vis = gt_kpts[..., 2]
    cost = focal_cls_cost(cls_logits, weight=cls_weight)[..., None]
    cost = cost + kpt_l1_cost(kpt_pred, gt_xy / factor, vis, kpt_weight)
    cost = cost + oks_cost(kpt_pred * factor, gt_xy, vis, gt_areas, sigmas,
                           oks_weight)
    return torch.where(torch.isfinite(cost), cost, torch.full_like(cost, 1e4))


def hungarian_assign(costs: Sequence[torch.Tensor],
                     gt_valid: torch.Tensor) -> List[torch.Tensor]:
    """Matched query per GT slot, ``(B, G)`` int64 (-1 = invalid), for each
    ``(B, Q_i, G)`` cost matrix; all matrices cross to the host in one
    copy."""
    B, _, G = costs[0].shape
    with torch.no_grad():
        flat = torch.cat([c.reshape(B, -1) for c in costs], 1).float()
        flat = flat.cpu().numpy()
    valid = gt_valid.cpu().numpy()
    out, start = [], 0
    for c in costs:
        Q = c.shape[1]
        block = flat[:, start:start + Q * G].reshape(B, Q, G)
        start += Q * G
        out.append(np.stack([hungarian_masked(block[b].T, valid[b])
                             for b in range(B)]))
    return [torch.from_numpy(q).to(gt_valid.device) for q in out]


class PoseTargets(NamedTuple):
    labels: torch.Tensor        # (B, Q) int64 class index (num_classes = bg)
    kpt_targets: torch.Tensor   # (B, G, K, 2) normalised gt xy
    kpt_weights: torch.Tensor   # (B, G, K, 2) visibility * validity
    area_targets: torch.Tensor  # (B, G)
    query_idx: torch.Tensor     # (B, G) matched query per gt (-1 = invalid)
    num_pos: torch.Tensor       # (B,) float


def build_pose_targets(query_idx, gt_valid, gt_kpts, gt_areas, img_shape,
                       num_query: int, num_classes: int = 1) -> PoseTargets:
    """Targets per GT slot (the caller gathers predictions at
    ``query_idx``); classification labels are scattered per query."""
    B = gt_kpts.shape[0]
    vis = (gt_kpts[..., 2] > 0).float()
    kpt_targets = gt_kpts[..., :2] / _factor(img_shape)
    kpt_weights = (vis * gt_valid[..., None].float())[..., None].expand(
        *vis.shape, 2)
    # invalid slots scatter into an extra column that is dropped
    labels = torch.full((B, num_query + 1), num_classes, dtype=torch.int64,
                        device=gt_kpts.device)
    safe_idx = torch.where(gt_valid, query_idx, num_query)
    labels.scatter_(1, safe_idx, 0)
    return PoseTargets(
        labels=labels[:, :num_query],
        kpt_targets=kpt_targets,
        kpt_weights=kpt_weights,
        area_targets=gt_areas,
        query_idx=query_idx,
        num_pos=gt_valid.sum(-1).float())
