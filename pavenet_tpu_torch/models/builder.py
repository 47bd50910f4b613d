"""Config dict -> detector (as ``pavenet_tpu/models/builder.py``: the
VideoPoseV1, VideoPoseV2 and PETR paths, a ResNet backbone with frozen or
trainable BatchNorm, a Swin Transformer or an HRNet, SOIT and DK-DETR, and
the activation dtype).

The PETR mapping follows the JAX builder's: a ``PETRHead`` defaults to
T=1, K=17 and L1 keypoint losses, takes its decoder queries from the
learned embedding alone and detaches the reference points between decoder
layers; ``with_heatmap`` follows the ``loss_hm`` weight; rescoring and
OKS-NMS follow ``test_cfg`` (default: on for the video head, off for
PETR's).

SOIT and DK-DETR follow the JAX ``_build_soit``: a ResNet only, ``norm_eval``
from the backbone (DK-DETR trains its BatchNorm), the loss and cost
weights from the config, DK-DETR's ``text_encoder.text_dim`` and
``temperature``. Like the JAX builder it reads neither
``model.output_mask`` (the DK-DETR test configs set it False; masks are
always predicted) nor ``ffn_dropout`` or ``frozen_stages`` (0.1 and 1, the
JAX module's fixed values and every config's)."""
from __future__ import annotations

import torch

from .detectors.soit import SOITDetector
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


def _backbone_kwargs(backbone: dict) -> dict:
    """A reference backbone config as detector arguments (ResNet, Swin
    Transformer, HRNet: its width from ``extra.stage4.num_channels``, the
    neck on branches 1-3)."""
    btype = _type_name(backbone, "ResNet")
    out_indices = tuple(backbone.get("out_indices", (1, 2, 3)))
    if btype == "ResNet":
        return dict(backbone_type="resnet",
                    backbone_depth=backbone.get("depth", 50),
                    backbone_out_indices=out_indices,
                    norm_eval=backbone.get("norm_eval", True),
                    frozen_stages=backbone.get("frozen_stages", 1))
    if btype == "SwinTransformer":
        return dict(backbone_type="swin", backbone_out_indices=out_indices,
                    swin_embed_dims=backbone.get("embed_dims", 192),
                    swin_depths=tuple(backbone.get("depths", (2, 2, 18, 2))),
                    swin_num_heads=tuple(
                        backbone.get("num_heads", (6, 12, 24, 48))),
                    swin_window_size=backbone.get("window_size", 7))
    if btype == "HRNet":
        stage4 = backbone.get("extra", {}).get("stage4", {})
        return dict(backbone_type="hrnet",
                    hrnet_width=stage4.get("num_channels", (48,))[0],
                    backbone_out_indices=(1, 2, 3))
    raise KeyError(f"unsupported backbone {btype!r}")


def _loss_weight(head, key, default):
    return head.get(key, {}).get("loss_weight", default)


def _build_soit(cfg: dict, impl: str, dtype: torch.dtype) -> SOITDetector:
    head = cfg.get("bbox_head", {})
    backbone = cfg.get("backbone", {})
    if _type_name(backbone, "ResNet") != "ResNet":
        raise KeyError("SOIT and DK-DETR take a ResNet backbone only")
    transformer = head.get("transformer", {})
    assigner = (cfg.get("train_cfg") or {}).get("assigner", {})

    def cost_weight(name, default):
        return assigner.get(name, {}).get("weight", default)

    dk = {}
    if _type_name(cfg) == "DKDETR":
        dk = dict(cls_emb_dim=cfg.get("text_encoder", {}).get("text_dim",
                                                               512),
                  temperature=cfg.get("temperature", 0.05))
    enc = transformer.get("encoder", {})
    enc_layers = enc.get("transformerlayers", {})
    return SOITDetector(
        norm_eval=backbone.get("norm_eval", True), **dk,
        num_classes=head.get("num_classes", 80),
        num_query=head.get("num_query", 300),
        max_gt=head.get("max_gt", 30),
        backbone_depth=backbone.get("depth", 50),
        embed_dims=enc_layers.get("attn_cfgs", {}).get("embed_dims", 256),
        feedforward_channels=enc_layers.get("feedforward_channels", 1024),
        num_encoder_layers=enc.get("num_layers", 6),
        num_decoder_layers=transformer.get("decoder", {}).get("num_layers",
                                                              6),
        mask_channels=transformer.get("mask_channels", 8),
        dynamic_params_dims=head.get("dynamic_params_dims", 441),
        loss_cls_weight=_loss_weight(head, "loss_cls", 2.0),
        loss_bbox_weight=_loss_weight(head, "loss_bbox", 5.0),
        loss_iou_weight=_loss_weight(head, "loss_iou", 2.0),
        dice_mask_loss_weight=head.get("dice_mask_loss_weight", 8.0),
        bce_mask_loss_weight=head.get("bce_mask_loss_weight", 2.0),
        cls_cost_weight=cost_weight("cls_cost", 2.0),
        reg_cost_weight=cost_weight("reg_cost", 5.0),
        iou_cost_weight=cost_weight("iou_cost", 2.0),
        max_per_img=(cfg.get("test_cfg") or {}).get("max_per_img", 100),
        impl=impl, dtype=dtype)


def build_detector(cfg: dict, impl: str = "auto",
                   dtype: torch.dtype = torch.float32):
    """Build the detector (``VideoPoseDetector`` or ``SOITDetector``) from
    a reference-style model config, in activation dtype ``dtype`` (see
    ``config.resolve_act_dtype``).

    ``encoder.mode`` is 'deformable' (the default) or 'windowed';
    VideoPoseV2 trains with backbone and neck frozen. Raises on what the
    port does not have: another detector (InsPose), backbone or head,
    another encoder mode, and a keypoint loss other than RLE and L1. The
    neck takes its input widths from the backbone.
    """
    det_type = _type_name(cfg)
    if det_type in ("SOIT", "DKDETR"):
        return _build_soit(cfg, impl, dtype)
    if det_type not in ("VideoPoseV1", "VideoPoseV2", "PETR"):
        raise KeyError(f"unsupported detector type {det_type!r} (the port "
                       "has VideoPoseV1, VideoPoseV2, PETR, SOIT and "
                       "DKDETR)")
    backbone = _backbone_kwargs(cfg.get("backbone", {}))
    head = cfg.get("bbox_head", {})
    head_type = _type_name(head, "PETRHead" if det_type == "PETR"
                           else "VideoPoseHeadMulFrames")
    if head_type not in ("VideoPoseHeadMulFrames", "PETRHead"):
        raise KeyError(f"unsupported head type {head_type!r}")
    is_petr = head_type == "PETRHead"
    transformer = head.get("transformer", {})
    encoder = transformer.get("encoder", {})
    encoder_mode = encoder.get("mode", "deformable")
    if encoder_mode not in ("deformable", "windowed"):
        raise KeyError(f"unsupported encoder mode {encoder_mode!r}")
    kpt_type = _type_name(head.get("loss_kpt"),
                          "L1Loss" if is_petr else "RLELoss")
    kpt_loss = {"RLELoss": "rle", "L1Loss": "l1"}.get(kpt_type)
    if kpt_loss is None:
        raise KeyError(f"unsupported loss_kpt {kpt_type!r} (the port has "
                       "RLELoss and L1Loss)")
    loss_hm_weight = _loss_weight(head, "loss_hm", 0.0)
    enc_layers = encoder.get("transformerlayers", {})
    test_cfg = cfg.get("test_cfg") or {}
    assigner = (cfg.get("train_cfg") or {}).get("assigner", {})

    def cost_weight(name, default):
        return assigner.get(name, {}).get("weight", default)

    return VideoPoseDetector(
        num_frames=head.get("num_frames", 1 if is_petr else 3),
        num_keypoints=head.get("num_keypoints", 17 if is_petr else 15),
        num_classes=head.get("num_classes", 1),
        num_query=head.get("num_query", 300),
        **backbone,
        freeze_backbone_neck=det_type == "VideoPoseV2",
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
        kpt_loss=kpt_loss,
        loss_oks_weight=_loss_weight(head, "loss_oks", 0.0),
        loss_oks_refine_weight=_loss_weight(head, "loss_oks_refine", 0.0),
        loss_hm_weight=loss_hm_weight, with_heatmap=loss_hm_weight > 0,
        query_from_encoder_token=not is_petr,
        detach_decoder_refs=is_petr,
        with_rescoring=test_cfg.get("with_rescoring", not is_petr),
        with_nms=test_cfg.get("with_nms", not is_petr),
        cls_cost_weight=cost_weight("cls_cost", 2.0),
        kpt_cost_weight=cost_weight("kpt_cost", 70.0),
        oks_cost_weight=cost_weight("oks_cost", 7.0),
        encoder_mode=encoder_mode, impl=impl, dtype=dtype)
