"""Model zoo (as ``pavenet_tpu/models/zoo.py``)."""
from __future__ import annotations

import numpy as np

from .detectors.videopose import VideoPoseDetector


def pavenet_r50_frames3(**overrides) -> VideoPoseDetector:
    """Production PAVE-Net: R50, 4-level neck, 6-layer encoder, 3-layer pose
    decoder, 2-layer joint decoder, T=3, K=15, 300 queries,
    max_per_img=20."""
    kwargs = dict(
        num_frames=3, num_keypoints=15, num_query=300, backbone_depth=50,
        embed_dims=256, num_encoder_layers=6, num_decoder_layers=3,
        num_refine_layers=2, max_per_img=20)
    kwargs.update(overrides)
    return VideoPoseDetector(**kwargs)


def dummy_clip_batch(rng: np.random.RandomState, batch_size: int = 1,
                     num_frames: int = 3, height: int = 800,
                     width: int = 1344) -> dict:
    """Synthetic inference batch in the canonical numpy layout, drawn as
    ``pavenet_tpu.models.zoo.dummy_clip_batch`` draws it."""
    B, T = batch_size, num_frames
    return {
        "img": rng.randn(B, T, height, width, 3).astype(np.float32),
        "img_shape": np.tile(
            np.array([[height, width - 11]], np.int32), (B, 1)),
        "scale_factor": np.full((B, 2), 0.6945, np.float32),
    }
