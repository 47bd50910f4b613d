"""Residual log-likelihood estimation loss (as ``pavenet_tpu/models/losses/
rle_loss.py``):

    loss = (log(sigma) - log_phi) * w[..., :1]
         + (log(sigma / amp) + |gt - mu| / (sqrt(2) sigma)) * w
    reduced by sum / num_valid

``log_phi`` is the flow's log-prob of ``(mu - gt) / sigma``, from the
caller.
"""
from __future__ import annotations

import math

import torch

_AMP = 1.0 / math.sqrt(2 * math.pi)


def rle_loss(pred, sigma, target, target_weight, log_phi, num_valid,
             loss_weight: float = 1.0) -> torch.Tensor:
    """pred/sigma/target/target_weight (..., K, 2); log_phi (..., K)."""
    nf_loss = (torch.log(sigma) - log_phi[..., None]) * target_weight[..., :1]
    q_logprob = (torch.log(sigma / _AMP)
                 + (target - pred).abs() / (math.sqrt(2) * sigma + 1e-9))
    loss = nf_loss + q_logprob * target_weight
    return loss.sum() / num_valid * loss_weight
