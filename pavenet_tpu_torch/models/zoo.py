"""Model zoo (as ``pavenet_tpu/models/zoo.py``)."""
from __future__ import annotations

import numpy as np

from .detectors.soit import SOITDetector
from .detectors.videopose import VideoPoseDetector


def pavenet_r50_frames3(**overrides) -> VideoPoseDetector:
    """Production PAVE-Net: R50, 4-level neck, 6-layer encoder, 3-layer pose
    decoder, 2-layer joint decoder, T=3, K=15, 300 queries,
    max_per_img=20. Any argument of ``VideoPoseDetector`` overrides, the
    activation dtype too (``dtype=torch.bfloat16``)."""
    kwargs = dict(
        num_frames=3, num_keypoints=15, num_query=300, backbone_depth=50,
        embed_dims=256, num_encoder_layers=6, num_decoder_layers=3,
        num_refine_layers=2, max_per_img=20)
    kwargs.update(overrides)
    return VideoPoseDetector(**kwargs)


# PETR's loss recipe and head options
# (``configs/petr/petr_r50_16x2_100e_coco.py``)
PETR_OPTIONS = dict(
    num_frames=1, num_keypoints=17, num_query=300, embed_dims=256,
    num_encoder_layers=6, num_decoder_layers=3, num_refine_layers=2,
    max_per_img=40, kpt_loss="l1", with_rescoring=False, with_heatmap=True,
    with_nms=False, query_from_encoder_token=False, detach_decoder_refs=True,
    loss_cls_weight=2.0, loss_kpt_weight=70.0, loss_kpt_rpn_weight=70.0,
    loss_kpt_refine_weight=80.0, loss_oks_weight=2.0,
    loss_oks_refine_weight=3.0, loss_hm_weight=4.0)


def petr_r50_coco(**overrides) -> VideoPoseDetector:
    """PETR on COCO: the T=1 case of the same architecture with an R50,
    K=17, 300 queries, max_per_img 40, L1 + OKS + heatmap losses, no
    rescoring and no NMS."""
    return VideoPoseDetector(**{**PETR_OPTIONS, "backbone_depth": 50,
                                **overrides})


def petr_swinl_coco(**overrides) -> VideoPoseDetector:
    """PETR with a Swin-L backbone
    (``configs/petr/petr_swin-l-p4-w7-224-22kto1k_16x1_100e_coco.py``)."""
    return VideoPoseDetector(**{**PETR_OPTIONS, "backbone_type": "swin",
                                **overrides})


def soit_r50_coco(**overrides) -> SOITDetector:
    """SOIT R50 (``configs/soit/soit_r50_16x2_50e_coco.py``): 80 classes,
    300 queries, 6 encoder and 6 decoder layers, 30 GT slots, 100
    detections, mask loss weights dice 8 and BCE 2."""
    kwargs = dict(num_classes=80, num_query=300, max_gt=30,
                  backbone_depth=50, embed_dims=256, num_encoder_layers=6,
                  num_decoder_layers=6, max_per_img=100,
                  dice_mask_loss_weight=8.0, bce_mask_loss_weight=2.0)
    kwargs.update(overrides)
    return SOITDetector(**kwargs)


def dummy_clip_batch(rng: np.random.RandomState, batch_size: int = 1,
                     num_frames: int = 3, height: int = 800,
                     width: int = 1344, num_keypoints: int = 15,
                     max_gt: int = 30, train: bool = False) -> dict:
    """Synthetic batch in the canonical numpy layout (see
    ``VideoPoseDetector``), drawn as ``pavenet_tpu.models.zoo.
    dummy_clip_batch`` draws it; ``train`` adds G=``max_gt`` GT slots, the
    first quarter valid."""
    B, T = batch_size, num_frames
    batch = {
        "img": rng.randn(B, T, height, width, 3).astype(np.float32),
        "img_shape": np.tile(
            np.array([[height, width - 11]], np.int32), (B, 1)),
        "scale_factor": np.full((B, 2), 0.6945, np.float32),
    }
    if train:
        K, G = num_keypoints, max_gt
        kpts = rng.rand(B, G, K, 3).astype(np.float32)
        kpts[..., 0] *= width - 11
        kpts[..., 1] *= height
        kpts[..., 2] = (kpts[..., 2] > 0.2).astype(np.float32)
        kpts[..., 0, 2] = 1.0
        valid = np.zeros((B, G), bool)
        valid[:, : max(1, G // 4)] = True
        batch.update(
            gt_keypoints=kpts,
            gt_areas=(rng.rand(B, G) * 5e3 + 1e3).astype(np.float32),
            gt_valid=valid)
    return batch
