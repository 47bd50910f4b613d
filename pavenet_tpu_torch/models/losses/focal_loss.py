"""Focal losses (as ``pavenet_tpu/models/losses/focal_loss.py``):
``sigmoid_focal_loss``, mmdet ``FocalLoss(use_sigmoid=True)``, where a
label equal to the class count means background; ``center_focal_loss``,
CornerNet's penalty-reduced heatmap loss (PETR's and InsPose's
``loss_hm``); ``varifocal_loss``, mmdet ``VarifocalLoss`` (InsPose's
``loss_cls``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...parallel.dist import global_sum


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor=1.0) -> torch.Tensor:
    """logits (N, C); labels int (N,) in [0, C] (C = background)."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes]
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = p * onehot + (1 - p) * (1 - onehot)
    focal_weight = (alpha * onehot + (1 - alpha) * (1 - onehot)) * (
        (1 - pt) ** gamma)
    bce = -(onehot * F.logsigmoid(logits)
            + (1 - onehot) * F.logsigmoid(-logits))
    return (bce * focal_weight).sum() / avg_factor


def center_focal_loss(pred: torch.Tensor, gt: torch.Tensor, mask=None,
                      eps: float = 1e-4) -> torch.Tensor:
    """pred (B, H, W, K) sigmoid probabilities; gt the same shape, Gaussian
    targets whose centres are exactly 1 (the positives); mask (B, H, W)
    bool, True = valid pixel. The sum over the positives' count, or the
    negatives' sum alone where there is no positive; over data-parallel
    ranks both the count and the branch are the global batch's."""
    pred = pred.clamp(eps, 1 - eps)
    pos = (gt == 1).to(pred.dtype)
    neg_weights = (1 - gt) ** 4
    pos_loss = torch.log(pred) * (1 - pred) ** 2 * pos
    neg_loss = torch.log(1 - pred) * pred ** 2 * neg_weights * (1 - pos)
    if mask is not None:
        m = mask[..., None].to(pred.dtype)
        pos_loss = pos_loss * m
        neg_loss = neg_loss * m
    # the positives of the global batch, over data-parallel ranks
    num_pos = global_sum(pos.sum())
    total = -(pos_loss.sum() + neg_loss.sum())
    return torch.where(num_pos > 0, total / num_pos.clamp(min=1.0),
                       -neg_loss.sum())


def varifocal_loss(logits: torch.Tensor, target_score: torch.Tensor,
                   gamma: float = 2.0, alpha: float = 0.75,
                   avg_factor=1.0) -> torch.Tensor:
    """mmdet ``VarifocalLoss(use_sigmoid=True, iou_weighted=True)``:
    ``target_score`` a soft quality in [0, 1] (InsPose: the decoded pose's
    OKS), positives (> 0) weighted by it and negatives by
    ``alpha * |p - t| ** gamma``; the sum over ``avg_factor``."""
    p = torch.sigmoid(logits)
    t = target_score.to(logits.dtype)
    pos = (t > 0.0).to(logits.dtype)
    focal_weight = t * pos + alpha * (p - t).abs() ** gamma * (1.0 - pos)
    bce = -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits))
    return (bce * focal_weight).sum() / avg_factor
