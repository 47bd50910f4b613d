"""PAVE-Net detector, serving path (as ``pavenet_tpu/models/detectors/
videopose.py``): backbone + neck + video pose head + Poseur rescoring and
OKS-NMS.

Batch dict (tensors on the model's device):
    img:          (B, T, H, W, 3) float32, normalised
    img_shape:    (B, 2) int (valid h, w) before padding
    scale_factor: (B, 2) float32 (w_scale, h_scale) test-time rescale
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from ..backbones.resnet import ResNet
from ..necks.channel_mapper import ChannelMapper
from ..dense_heads.videopose_head import VideoPoseHead
from ...ops.nms import oks_nms_keep

# per-keypoint OKS sigmas (``pavenet_tpu/models/losses/oks_loss.py``)
OKS_SIGMAS = {
    17: (.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
         .87, .87, .89, .89),
    15: (.26, .79, .79, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87,
         .89, .89),
    14: (.79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89, .79,
         .79),
}


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator):
    """The JAX package's default kernel init: truncated normal, variance
    1/fan_in."""
    fan_in = tensor[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation at 2
    nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class VideoPoseDetector(nn.Module):
    """Flagship video model (T=3, K=15, R50)."""

    def __init__(self, num_frames: int = 3, num_keypoints: int = 15,
                 num_classes: int = 1, num_query: int = 300,
                 backbone_depth: int = 50,
                 backbone_out_indices: Tuple[int, ...] = (1, 2, 3),
                 embed_dims: int = 256, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 3, num_refine_layers: int = 2,
                 feedforward_channels: int = 1024, max_per_img: int = 20,
                 impl: str = "auto"):
        super().__init__()
        self.num_frames, self.num_keypoints = num_frames, num_keypoints
        self.max_per_img = max_per_img
        self.backbone = ResNet(backbone_depth, backbone_out_indices)
        self.neck = ChannelMapper(self.backbone.out_channels, embed_dims,
                                  num_outs=4)
        self.head = VideoPoseHead(
            num_classes=num_classes, num_frames=num_frames,
            num_keypoints=num_keypoints, num_query=num_query,
            embed_dims=embed_dims, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            num_refine_layers=num_refine_layers,
            feedforward_channels=feedforward_channels, impl=impl)
        self.register_buffer(
            "oks_sigmas",
            torch.tensor(OKS_SIGMAS[num_keypoints]) / 10.0, persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights that follow the JAX initialisers wherever those fix
        a value (spoke offset biases, zero-init kernels, the cls prior bias,
        ``normal(1.0)`` embeddings, identity frozen BN)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for m in self.modules():
            if hasattr(m, "init_fixed_"):
                m.init_fixed_(generator)

    # ------------------------------------------------------------------
    def extract_feats(self, img):
        """(B, T, H, W, 3) -> list of (B, T, h, w, C); frames folded into the
        batch through backbone and neck."""
        B, T, H, W, _ = img.shape
        x = img.reshape(B * T, H, W, 3).permute(0, 3, 1, 2)
        feats = self.neck(self.backbone(x))
        return [f.view(B, T, *f.shape[1:]).permute(0, 1, 3, 4, 2)
                for f in feats]

    @staticmethod
    def level_masks(img_shape, input_hw, level_shapes):
        """Per-level padding masks (True = pad) and valid ratios (B, L, 2)
        from the valid image sizes (nearest-downsample semantics)."""
        H, W = input_hw
        img_h = img_shape[:, 0].float()
        img_w = img_shape[:, 1].float()
        dev = img_shape.device
        masks, ratios = [], []
        for (h_l, w_l) in level_shapes:
            yy = torch.arange(h_l, dtype=torch.float32, device=dev)[None]
            xx = torch.arange(w_l, dtype=torch.float32, device=dev)[None]
            row_valid = yy < img_h[:, None] * h_l / H       # (B, h_l)
            col_valid = xx < img_w[:, None] * w_l / W       # (B, w_l)
            masks.append(~(row_valid[:, :, None] & col_valid[:, None, :]))
            ratios.append(torch.stack([col_valid.sum(-1) / w_l,
                                       row_valid.sum(-1) / h_l], -1))
        return masks, torch.stack(ratios, 1).float()

    def forward_outputs(self, img, img_shape):
        feats = self.extract_feats(img)
        level_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        mlvl_masks, valid_ratios = self.level_masks(
            img_shape, img.shape[2:4], level_shapes)
        outs = self.head(feats, mlvl_masks, valid_ratios)
        outs["valid_ratios"] = valid_ratios
        return outs

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_test(self, batch):
        """Padded detections per image, in the original image's pixels:
        det_kpts (B, M, K, 3), det_bboxes (B, M, 5), det_labels (B, M),
        keep (B, M) (OKS-NMS)."""
        outs = self.forward_outputs(batch["img"], batch["img_shape"])
        B = batch["img"].shape[0]
        K, M = self.num_keypoints, self.max_per_img

        cls_score = outs["all_cls_scores"][-1][..., 0].sigmoid()
        scores, bbox_index = cls_score.topk(M, dim=1)             # (B, M)
        frame_preds = outs["frame_kpt_preds"]                     # (B,T,Q,2K)
        T = frame_preds.shape[1]
        ref_poses = torch.gather(
            frame_preds, 2, bbox_index[:, None, :, None].expand(
                B, T, M, frame_preds.shape[-1])).transpose(1, 2)  # (B,M,T,2K)

        refine_kpts, _, refine_sigmas = self.head.forward_refine(
            outs["memory"], outs["mask_flatten"], outs["valid_ratios"],
            ref_poses, outs["spatial_shapes"])
        det_kpts = refine_kpts[-1]                                # (B,M,K,2)
        det_sigmas = refine_sigmas[-1]

        img_h = batch["img_shape"][:, 0].float()[:, None, None]
        img_w = batch["img_shape"][:, 1].float()[:, None, None]
        x = torch.minimum(torch.clamp(det_kpts[..., 0] * img_w, min=0), img_w)
        y = torch.minimum(torch.clamp(det_kpts[..., 1] * img_h, min=0), img_h)
        det_kpts = torch.stack([x, y], -1) / batch["scale_factor"][:, None,
                                                                   None, :]

        # circumscribed-rectangle boxes
        det_bboxes = torch.stack(
            [det_kpts[..., 0].amin(-1), det_kpts[..., 1].amin(-1),
             det_kpts[..., 0].amax(-1), det_kpts[..., 1].amax(-1), scores],
            -1)

        # Poseur rescoring: p_x = 0.2, * 0.7, power 5
        p = 1.0 - torch.exp(-(0.2 / det_sigmas.clamp(min=1e-6)))
        p = (p[..., 0] * p[..., 1])[..., None] * 0.7              # (B,M,K,1)
        det_kpts = det_kpts * p ** 5 / (p ** 5 + 1e-10)
        det_kpts = torch.cat([det_kpts, scores[:, :, None, None] * p], -1)

        areas = ((det_kpts[..., 0].amax(-1) - det_kpts[..., 0].amin(-1))
                 * (det_kpts[..., 1].amax(-1) - det_kpts[..., 1].amin(-1)))
        keep = torch.stack([
            oks_nms_keep(det_kpts[b, ..., :2], scores[b], areas[b],
                         self.oks_sigmas)
            for b in range(B)])
        return dict(det_kpts=det_kpts, det_bboxes=det_bboxes,
                    det_labels=torch.zeros((B, M), dtype=torch.int32,
                                           device=scores.device),
                    keep=keep)
