"""Focal loss (as ``pavenet_tpu/models/losses/focal_loss.py``):
``sigmoid_focal_loss``, mmdet ``FocalLoss(use_sigmoid=True)``, where a
label equal to the class count means background."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
