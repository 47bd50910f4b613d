"""Batch preparation on the card (as ``pavenet_tpu/apis/prep.py``).

The pipelines built with ``normalize_on_device=True`` send the image as
uint8, a quarter of the bytes of float32, and leave the host's Normalize
pass out. ``device_prep`` then computes ``(x - mean) / std`` in float32
where the batch lives and zeroes the bucket padding, so that the result
is what the host chain Normalize -> PadToBucket gives (padding after
normalising is zeros). A float batch passes through untouched, so every
entry point applies it whatever the feed.
"""
from __future__ import annotations

from typing import Mapping

import torch

IMG_NORM_MEAN = (123.675, 116.28, 103.53)
IMG_NORM_STD = (58.395, 57.12, 57.375)


def device_prep(feed: Mapping, img_norm=(IMG_NORM_MEAN, IMG_NORM_STD)
                ) -> dict:
    """``feed['img']``: (B, T, H, W, 3) uint8 (any float dtype passes
    through); ``feed['img_shape']``: (B, 2) valid (h, w) per sample, beyond
    which is bucket padding. Returns the feed with ``img`` normalised."""
    img = feed["img"]
    if img.dtype != torch.uint8:
        return dict(feed)
    mean, std = (torch.tensor(v, dtype=torch.float32, device=img.device)
                 for v in img_norm)
    x = (img.float() - mean) / std
    B, T, H, W, _ = x.shape
    shp = feed["img_shape"].to(img.device)
    rows = torch.arange(H, device=img.device).view(1, 1, H, 1, 1)
    cols = torch.arange(W, device=img.device).view(1, 1, 1, W, 1)
    inside = ((rows < shp[:, 0].view(B, 1, 1, 1, 1))
              & (cols < shp[:, 1].view(B, 1, 1, 1, 1)))
    return dict(feed, img=torch.where(inside, x, x.new_zeros(())))
