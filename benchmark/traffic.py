"""The one generator of the benchmark's traffic: a mix is a data file
``benchmark/traffic/<mix>.json`` of parameters, read here.

Keys of a mix:

- ``kind``: ``serve`` (a closed loop of requests, ``benchmark/serve.py``)
  or ``train`` (mini-steps of the recipe, ``benchmark/train.py``);
- ``height``, ``width``: the bucket every clip is padded to;
  ``img_shape``: the valid (h, w) inside it; ``scale_factor``: the
  resize from the source frames (serving reports in their pixels);
- ``clips_per_request``: clips a request or a mini-step carries;
- ``pool``: distinct requests or batches drawn from the seed and cycled;
- serving: ``clients`` (closed loop), ``check_requests`` (how many served
  requests the reference checks); training: ``gt_slots``, ``valid_share``
  (the GT slots that hold a person).

Every seed gives the same sizes; only the pixels and the people differ.
The frames are uint8, as a decoder gives them, made on the device in one
draw and kept on the host.
"""
from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) % 2 ** 63)


def _clips(mix: Mapping, n: int, frames: int, gen, device) -> np.ndarray:
    """``n`` requests of uint8 clips ``(n, B, T, H, W, 3)``, zero beyond
    ``img_shape`` (the bucket padding)."""
    B = mix["clips_per_request"]
    H, W = mix["height"], mix["width"]
    h, w = mix["img_shape"]
    img = torch.randint(0, 256, (n, B, frames, H, W, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    img[:, :, :, h:] = 0
    img[:, :, :, :, w:] = 0
    return img.cpu().numpy()


def _shape_fields(mix: Mapping) -> dict:
    B = mix["clips_per_request"]
    return dict(
        img_shape=np.tile(np.array([mix["img_shape"]], np.int32), (B, 1)),
        scale_factor=np.full((B, 2), mix["scale_factor"], np.float32))


def serve_pool(mix: Mapping, seed: int, frames: int, device) -> List[dict]:
    """The requests of a serving mix: ``pool`` numpy batches ``img (B, T,
    H, W, 3)`` uint8, ``img_shape (B, 2)``, ``scale_factor (B, 2)``."""
    gen = _generator(seed, 1, device)
    imgs = _clips(mix, mix["pool"], frames, gen, device)
    return [dict(img=img, **_shape_fields(mix)) for img in imgs]


def train_pool(mix: Mapping, seed: int, frames: int, num_keypoints: int,
               device) -> List[dict]:
    """The mini-batches of a training mix: as ``serve_pool`` plus
    ``gt_keypoints (B, G, K, 3)`` (xy in the valid image, visibility 1 with
    probability 0.8, the first keypoint always visible), ``gt_areas (B,
    G)`` in [1e3, 6e3) px^2 and ``gt_valid (B, G)``, the first
    ``valid_share`` of the slots valid."""
    gen = _generator(seed, 2, device)
    n, B = mix["pool"], mix["clips_per_request"]
    G, K = mix["gt_slots"], num_keypoints
    imgs = _clips(mix, n, frames, gen, device)
    h, w = mix["img_shape"]
    u = torch.rand((n, B, G, K, 3), generator=gen, device=device).cpu()
    areas = torch.rand((n, B, G), generator=gen, device=device).cpu()
    kpts = u.numpy().copy()
    kpts[..., 0] *= w
    kpts[..., 1] *= h
    kpts[..., 2] = (kpts[..., 2] > 0.2).astype(np.float32)
    kpts[..., 0, 2] = 1.0
    valid = np.zeros((B, G), bool)
    valid[:, :max(1, int(G * mix["valid_share"]))] = True
    return [dict(img=imgs[i], **_shape_fields(mix),
                 gt_keypoints=kpts[i],
                 gt_areas=(areas[i].numpy() * 5e3 + 1e3).astype(np.float32),
                 gt_valid=valid.copy())
            for i in range(n)]
