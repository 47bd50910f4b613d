"""Config dict -> detector, frozen from the port's ``models/builder.py``:
the VideoPoseV1 path with a ResNet (``norm_eval``) or Swin backbone, in
float32. Raises on what this reference does not have, so that a
configuration never runs with part of its mathematics silently left out:
another detector, backbone or head, the windowed encoder, a keypoint loss
other than RLE, a weighted OKS or heatmap loss, trainable BatchNorm, drop
path, and a test path without rescoring or NMS. The neck takes its input
widths from the backbone."""
from __future__ import annotations

from .detectors.videopose import VideoPoseDetector

KNOWN_SCOPES = ("opera", "mmdet", "mmcv", "pavenet", "torch")


def split_scope_key(key: str):
    """Split 'scope.Key' into (scope, Key); scope is None if absent (as
    ``pavenet_tpu/registry.py``)."""
    split_index = key.find(".")
    if split_index != -1 and key[:split_index] in KNOWN_SCOPES:
        return key[:split_index], key[split_index + 1:]
    return None, key


def _type_name(cfg, default=None):
    if cfg is None:
        return default
    return split_scope_key(cfg.get("type", default))[1]


def _require(ok: bool, what: str):
    if not ok:
        raise KeyError(f"the reference does not have {what}")


def _backbone_kwargs(backbone: dict) -> dict:
    """A reference backbone config as detector arguments."""
    btype = _type_name(backbone, "ResNet")
    out_indices = tuple(backbone.get("out_indices", (1, 2, 3)))
    if btype == "ResNet":
        _require(backbone.get("norm_eval", True), "trainable BatchNorm")
        return dict(backbone_type="resnet",
                    backbone_depth=backbone.get("depth", 50),
                    backbone_out_indices=out_indices,
                    frozen_stages=backbone.get("frozen_stages", 1))
    if btype == "SwinTransformer":
        _require(backbone.get("drop_path_rate", 0.0) == 0.0,
                 "drop path (stochastic depth)")
        return dict(backbone_type="swin", backbone_out_indices=out_indices,
                    swin_embed_dims=backbone.get("embed_dims", 192),
                    swin_depths=tuple(backbone.get("depths", (2, 2, 18, 2))),
                    swin_num_heads=tuple(
                        backbone.get("num_heads", (6, 12, 24, 48))),
                    swin_window_size=backbone.get("window_size", 7))
    raise KeyError(f"unsupported backbone {btype!r}")


def _loss_weight(head, key, default):
    return head.get(key, {}).get("loss_weight", default)


def build_detector(cfg: dict):
    """Build the ``VideoPoseDetector`` of a reference-style model config."""
    _require(_type_name(cfg) == "VideoPoseV1",
             f"detector type {_type_name(cfg)!r}")
    backbone = _backbone_kwargs(cfg.get("backbone", {}))
    head = cfg.get("bbox_head", {})
    _require(_type_name(head, "VideoPoseHeadMulFrames")
             == "VideoPoseHeadMulFrames", "that head type")
    transformer = head.get("transformer", {})
    encoder = transformer.get("encoder", {})
    _require(encoder.get("mode", "deformable") == "deformable",
             "the windowed encoder")
    for key in ("loss_kpt", "loss_kpt_rpn", "loss_kpt_refine"):
        _require(_type_name(head.get(key), "RLELoss") == "RLELoss",
                 f"a {key} other than RLELoss")
    for key in ("loss_oks", "loss_oks_refine", "loss_hm"):
        _require(_loss_weight(head, key, 0.0) == 0.0, f"a weighted {key}")
    enc_layers = encoder.get("transformerlayers", {})
    test_cfg = cfg.get("test_cfg") or {}
    _require(test_cfg.get("with_rescoring", True)
             and test_cfg.get("with_nms", True),
             "a test path without rescoring or NMS")
    assigner = (cfg.get("train_cfg") or {}).get("assigner", {})

    def cost_weight(name, default):
        return assigner.get(name, {}).get("weight", default)

    return VideoPoseDetector(
        num_frames=head.get("num_frames", 3),
        num_keypoints=head.get("num_keypoints", 15),
        num_classes=head.get("num_classes", 1),
        num_query=head.get("num_query", 300),
        **backbone,
        embed_dims=enc_layers.get("attn_cfgs", {}).get("embed_dims", 256),
        feedforward_channels=enc_layers.get("feedforward_channels", 1024),
        dropout=enc_layers.get("ffn_dropout", 0.1),
        num_encoder_layers=encoder.get("num_layers", 6),
        num_decoder_layers=transformer.get("decoder", {}).get("num_layers", 3),
        num_refine_layers=transformer.get("refine_decoder", {}).get(
            "num_layers", 2),
        max_per_img=test_cfg.get("max_per_img", 100),
        loss_cls_weight=_loss_weight(head, "loss_cls", 0.5),
        loss_kpt_weight=_loss_weight(head, "loss_kpt", 1.0),
        loss_kpt_rpn_weight=_loss_weight(head, "loss_kpt_rpn", 1.0),
        loss_kpt_refine_weight=_loss_weight(head, "loss_kpt_refine", 1.0),
        cls_cost_weight=cost_weight("cls_cost", 2.0),
        kpt_cost_weight=cost_weight("kpt_cost", 70.0),
        oks_cost_weight=cost_weight("oks_cost", 7.0))
