"""Config dict -> detector (as ``pavenet_tpu/models/builder.py``,
VideoPoseV1 serving path only)."""
from __future__ import annotations

from pavenet_tpu.registry import split_scope_key

from .detectors.videopose import VideoPoseDetector


def _type_name(cfg, default=None):
    if cfg is None:
        return default
    return split_scope_key(cfg.get("type", default))[1]


def build_detector(cfg: dict, impl: str = "auto") -> VideoPoseDetector:
    """Build the video pose detector from a reference-style model config."""
    det_type = _type_name(cfg)
    if det_type != "VideoPoseV1":
        raise KeyError(f"unsupported detector type {det_type!r} (the port "
                       "serves VideoPoseV1)")
    backbone = cfg.get("backbone", {})
    if _type_name(backbone, "ResNet") != "ResNet":
        raise KeyError(f"unsupported backbone {backbone.get('type')!r}")
    if not backbone.get("norm_eval", True):
        raise KeyError("trainable BatchNorm (norm_eval=False) is not ported")
    head = cfg.get("bbox_head", {})
    head_type = _type_name(head, "VideoPoseHeadMulFrames")
    if head_type != "VideoPoseHeadMulFrames":
        raise KeyError(f"unsupported head type {head_type!r}")
    transformer = head.get("transformer", {})
    encoder = transformer.get("encoder", {})
    if encoder.get("mode", "deformable") != "deformable":
        raise KeyError("the windowed encoder is not ported")
    enc_layers = encoder.get("transformerlayers", {})
    test_cfg = cfg.get("test_cfg") or {}
    if not (test_cfg.get("with_rescoring", True)
            and test_cfg.get("with_nms", True)):
        raise KeyError("the port always rescores and runs OKS-NMS")
    return VideoPoseDetector(
        num_frames=head.get("num_frames", 3),
        num_keypoints=head.get("num_keypoints", 15),
        num_classes=head.get("num_classes", 1),
        num_query=head.get("num_query", 300),
        backbone_depth=backbone.get("depth", 50),
        backbone_out_indices=tuple(backbone.get("out_indices", (1, 2, 3))),
        embed_dims=enc_layers.get("attn_cfgs", {}).get("embed_dims", 256),
        feedforward_channels=enc_layers.get("feedforward_channels", 1024),
        num_encoder_layers=encoder.get("num_layers", 6),
        num_decoder_layers=transformer.get("decoder", {}).get("num_layers", 3),
        num_refine_layers=transformer.get("refine_decoder", {}).get(
            "num_layers", 2),
        max_per_img=test_cfg.get("max_per_img", 100),
        impl=impl)
