"""Greedy OKS-NMS, box NMS and linear soft-NMS (as
``pavenet_tpu/ops/nms.py``)."""
from __future__ import annotations

import numpy as np
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
    """Pairwise IoU of ``(..., N, 4)`` xyxy boxes: ``(..., N, N)``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)

    def pair(a, b, op):
        return op(a[..., :, None], b[..., None, :])

    iw = (pair(x2, x2, torch.minimum) - pair(x1, x1, torch.maximum)).clamp(
        min=0)
    ih = (pair(y2, y2, torch.minimum) - pair(y1, y1, torch.maximum)).clamp(
        min=0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
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


def soft_nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thr: float = 0.3) -> torch.Tensor:
    """Linear soft-NMS (mmcv ``soft_nms``, ``method='linear'``; InsPose's
    test config, IoU 0.3): the decayed scores of ``(..., N)`` candidates
    with ``(..., N, 4)`` xyxy boxes, float32, on the scores' device.

    Each of the N greedy rounds picks the highest unprocessed score (the
    first on a tie) and multiplies every other unprocessed score by
    ``1 - iou`` where its IoU with the pick is above ``iou_thr``. The IoU
    matrix is formed where the boxes lie; the rounds, which are sequential
    and tiny, run on the host in float32 after one copy (the arithmetic
    and its order are the JAX loop's), vectorised over the leading
    axes."""
    iou = box_iou_matrix(boxes.float()).cpu().numpy()
    cur = scores.detach().float().cpu().numpy().copy()
    lead, N = cur.shape[:-1], cur.shape[-1]
    iou = iou.reshape(-1, N, N)
    cur = cur.reshape(-1, N)
    rows = np.arange(cur.shape[0])
    processed = np.zeros(cur.shape, bool)
    one = np.float32(1.0)
    for _ in range(N):
        masked = np.where(processed, -np.inf, cur).astype(np.float32)
        i = masked.argmax(-1)
        valid = np.isfinite(masked[rows, i])
        row = iou[rows, i]                                   # (R, N)
        decay = np.where(row > iou_thr, one - row, one)
        decay = np.where(valid[:, None], decay, one)
        sel = np.arange(N)[None] == i[:, None]
        cur = np.where(processed | sel, cur, cur * decay)
        processed |= sel
    return torch.from_numpy(cur.reshape(*lead, N)).to(scores.device)
