"""Greedy OKS-NMS and box NMS in plain tensor code (as
``pavenet_tpu/ops/nms.py``)."""
from __future__ import annotations

import torch


def oks_iou_matrix(kpts: torch.Tensor, areas: torch.Tensor,
                   sigmas: torch.Tensor) -> torch.Tensor:
    """Pairwise OKS of ``(N, K, 2)`` poses with ``(N,)`` areas: per-keypoint
    gaussian of variance ``(2*sigma)**2`` over the mean of the two areas,
    all K keypoints counted. Returns ``(N, N)``."""
    variances = (sigmas * 2.0) ** 2
    d2 = ((kpts[:, None] - kpts[None, :]) ** 2).sum(-1)          # (N,N,K)
    mean_area = (areas[:, None] + areas[None, :]) / 2.0 + 1e-16
    e = d2 / variances / mean_area[..., None] / 2.0
    return torch.exp(-e).mean(-1)


def _greedy_keep(scores: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    """Bool keep mask ``(N,)``: candidates are visited in descending score
    order (stable for ties) and kept iff no earlier kept one overlaps them
    (``over`` (N, N) True); non-finite scores are never kept."""
    order = torch.argsort(-scores, stable=True)
    over = over[order][:, order]
    valid = torch.isfinite(scores[order])
    keep_sorted = torch.zeros_like(valid)
    for i in range(scores.shape[0]):
        suppressed = (keep_sorted[:i] & over[i, :i]).any()
        keep_sorted[i] = valid[i] & ~suppressed
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def oks_nms_keep(kpts: torch.Tensor, scores: torch.Tensor,
                 areas: torch.Tensor, sigmas: torch.Tensor,
                 thresh: float = 0.45) -> torch.Tensor:
    """Greedy OKS-NMS keep mask ``(N,)``: a pose is suppressed by an
    earlier kept one with OKS > ``thresh``."""
    return _greedy_keep(scores, oks_iou_matrix(kpts, areas, sigmas) > thresh)


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``(N, 4)`` xyxy boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, None], x2[None]) -
          torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    ih = (torch.minimum(y2[:, None], y2[None]) -
          torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = iw * ih
    union = area[:, None] + area[None] - inter
    return inter / union.clamp(min=1e-9)


def box_nms_keep(boxes: torch.Tensor, scores: torch.Tensor,
                 iou_thr: float = 0.7, score_thr: float = 0.0
                 ) -> torch.Tensor:
    """Greedy box NMS keep mask ``(N,)`` (the one-class case of mmdet's
    ``multiclass_nms``): candidates at or below ``score_thr`` are dropped,
    and a box is suppressed by an earlier kept one with IoU > ``iou_thr``."""
    scores = torch.where(scores > score_thr, scores,
                         torch.full_like(scores, -float("inf")))
    return _greedy_keep(scores, box_iou_matrix(boxes) > iou_thr)
