"""Greedy OKS-NMS (as ``pavenet_tpu/ops/nms.py``)."""
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
