"""PAVE-Net detector (as ``pavenet_tpu/models/detectors/videopose.py``):
backbone (ResNet, Swin or HRNet) + neck + video pose head, with the train
step's losses (``forward_train``: Hungarian matching, focal and RLE or L1
keypoint losses, and PETR's OKS and heatmap losses where weighted), the
test path's Poseur rescoring and OKS-NMS (``forward_test``; PETR has
neither: unit keypoint scores, every detection kept), and flip and
multi-scale test-time augmentation (``forward_test_flip``,
``forward_test_aug``, ``merge_aug_detections``: box NMS over the union).
With ``num_frames=1`` and the PETR options (``models/zoo.py::
petr_r50_coco``) it is the single-frame PETR detector.

Trainable BatchNorm (``norm_eval=False``) is in train mode in
``forward_train`` and in eval mode elsewhere, whatever ``nn.Module.training``
says (that flag drives dropout only), as the JAX detector's ``train``
argument does; ``freeze_backbone_neck`` (VideoPoseV2) detaches the neck's
features. ``dtype`` is the activation dtype of backbone, neck and head
(``models/layers/dtype.py``); parameters stay float32.

Batch dict (tensors on the model's device):
    img:          (B, T, H, W, 3) float32, normalised
    img_shape:    (B, 2) int (valid h, w) before padding
    scale_factor: (B, 2) float32 (w_scale, h_scale) test-time rescale
    gt_keypoints: (B, G, K, 3) xyv, unnormalised (train)
    gt_areas:     (B, G) float32 (train)
    gt_valid:     (B, G) bool (train)
    gt_bboxes:    (B, G, 4) xyxy (train, optional: the heatmap target's
                  radius; without it the visible keypoints' envelope)
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from ..backbones.hrnet import HRNet
from ..backbones.resnet import ResNet
from ..backbones.swin import SwinTransformer
from ..necks.channel_mapper import ChannelMapper
from ..dense_heads.videopose_head import VideoPoseHead
from ..losses import (OKS_SIGMAS, center_focal_loss, oks_loss, rle_loss,
                      sigmoid_focal_loss)
from ...core.assigner import (PoseTargets, build_pose_targets,
                              hungarian_assign, pose_match_cost)
from ...ops.nms import box_nms_keep, oks_nms_keep

# left/right keypoint pairs by keypoint count (COCO, PoseTrack, CrowdPose)
FLIP_PAIRS_BY_K = {
    17: ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
         (15, 16)),
    15: ((3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14)),
    14: ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11)),
}
# the test-time augmentation merge: box NMS at this IoU, every score kept
# (the reference's ``aug_test`` with ``multiclass_nms``)
TTA_NMS_IOU = 0.7
# the heatmap target's stride: level 0 of the neck
HM_STRIDE = 8.0


def gaussian_radius(height, width, min_overlap: float = 0.7):
    """CornerNet's Gaussian radius, divided by 2 where CornerNet divides by
    2a, as the reference does."""
    def safe_sqrt(x):
        return torch.sqrt(x.clamp(min=0.0))
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + safe_sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + safe_sqrt(b2 ** 2 - 16 * c2)) / 2
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + safe_sqrt(b3 ** 2 - 16 * min_overlap * c3)) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def heatmap_target(batch, shape) -> torch.Tensor:
    """PETR's level-0 keypoint heatmaps (B, h0, w0, K), float32: for each
    visible keypoint of a valid GT slot a Gaussian at its stride-8 cell,
    with the radius from the slot's ``gt_bboxes`` (or the visible
    keypoints' envelope) at stride 8 (``gaussian_radius`` at overlap 0.9,
    floored, clipped to [0, 3]) and sigma (2r + 1) / 6, zero outside the
    radius; the slots combined by an element-wise max. Centres are exactly
    1."""
    B, h0, w0, K = shape
    kpts = batch["gt_keypoints"].float()                   # (B, G, K, 3)
    vis = kpts[..., 2] > 0
    valid = batch["gt_valid"][:, :, None] & vis            # (B, G, K)
    if "gt_bboxes" in batch:
        x1, y1, x2, y2 = batch["gt_bboxes"].float().unbind(-1)
    else:
        big = 1e9
        x1 = torch.where(vis, kpts[..., 0], big).amin(-1)
        y1 = torch.where(vis, kpts[..., 1], big).amin(-1)
        x2 = torch.where(vis, kpts[..., 0], -big).amax(-1)
        y2 = torch.where(vis, kpts[..., 1], -big).amax(-1)
    gw = ((x2 - x1) / HM_STRIDE).clamp(min=0.0)
    gh = ((y2 - y1) / HM_STRIDE).clamp(min=0.0)
    radius = gaussian_radius(gh, gw, 0.9).floor().clamp(0.0, 3.0)  # (B, G)
    sigma = (2 * radius + 1) / 6.0
    cx = (kpts[..., 0] / HM_STRIDE).floor()                 # (B, G, K)
    cy = (kpts[..., 1] / HM_STRIDE).floor()
    dev = kpts.device
    dy = torch.arange(h0, dtype=torch.float32, device=dev) - cy[..., None]
    dx = torch.arange(w0, dtype=torch.float32, device=dev) - cx[..., None]
    r = radius[:, :, None, None, None]
    s2 = 2 * sigma[:, :, None, None, None] ** 2 + 1e-12
    d2 = dy[..., :, None] ** 2 + dx[..., None, :] ** 2      # (B,G,K,h0,w0)
    inside = ((dy.abs()[..., :, None] <= r) & (dx.abs()[..., None, :] <= r)
              & valid[..., None, None])
    gsn = torch.where(inside, torch.exp(-d2 / s2), torch.zeros_like(d2))
    return gsn.amax(1).permute(0, 2, 3, 1)


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator):
    """The JAX package's default kernel init: truncated normal, variance
    1/fan_in."""
    fan_in = tensor[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation at 2
    nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def jax_like_init_(model: nn.Module, generator: torch.Generator):
    """Random weights that follow the JAX initialisers wherever those fix a
    value (spoke offset biases, zero-init kernels, the cls prior bias,
    ``normal(1.0)`` embeddings, identity BatchNorm): LeCun-normal kernels
    and zero biases, unit norms, then each module's ``init_fixed_``."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for m in model.modules():
        if hasattr(m, "init_fixed_"):
            m.init_fixed_(generator)


class VideoPoseDetector(nn.Module):
    """Flagship video model (T=3, K=15, R50); ``backbone_type`` 'swin'
    takes a Swin Transformer (Swin-L by default), 'hrnet' an HRNet
    (``hrnet_width`` 48 or 32), in place of the ResNet. ``kpt_loss`` is
    'rle' (video) or 'l1' (PETR); ``loss_oks_weight``,
    ``loss_oks_refine_weight`` and ``loss_hm_weight`` above 0 add PETR's
    OKS and heatmap losses (the heatmap needs ``with_heatmap``);
    ``with_rescoring`` and ``with_nms`` pick the test path's Poseur
    rescoring and OKS-NMS."""

    def __init__(self, num_frames: int = 3, num_keypoints: int = 15,
                 num_classes: int = 1, num_query: int = 300,
                 backbone_type: str = "resnet", backbone_depth: int = 50,
                 backbone_out_indices: Tuple[int, ...] = (1, 2, 3),
                 swin_embed_dims: int = 192,
                 swin_depths: Tuple[int, ...] = (2, 2, 18, 2),
                 swin_num_heads: Tuple[int, ...] = (6, 12, 24, 48),
                 swin_window_size: int = 7, hrnet_width: int = 48,
                 embed_dims: int = 256, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 3, num_refine_layers: int = 2,
                 feedforward_channels: int = 1024, dropout: float = 0.1,
                 max_per_img: int = 20, frozen_stages: int = 1,
                 loss_cls_weight: float = 0.5, loss_kpt_weight: float = 1.0,
                 loss_kpt_rpn_weight: float = 1.0,
                 loss_kpt_refine_weight: float = 1.0,
                 cls_cost_weight: float = 2.0, kpt_cost_weight: float = 70.0,
                 oks_cost_weight: float = 7.0, kpt_loss: str = "rle",
                 loss_oks_weight: float = 0.0,
                 loss_oks_refine_weight: float = 0.0,
                 loss_hm_weight: float = 0.0, with_heatmap: bool = False,
                 with_rescoring: bool = True, with_nms: bool = True,
                 query_from_encoder_token: bool = True,
                 detach_decoder_refs: bool = False,
                 encoder_mode: str = "deformable", impl: str = "auto",
                 norm_eval: bool = True, freeze_backbone_neck: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_frames, self.num_keypoints = num_frames, num_keypoints
        self.num_classes = num_classes
        self.max_per_img = max_per_img
        if kpt_loss not in ("rle", "l1"):
            raise ValueError(f"unknown kpt_loss {kpt_loss!r}")
        self.kpt_loss = kpt_loss
        self.with_rescoring, self.with_nms = with_rescoring, with_nms
        self.backbone_type = backbone_type
        self.backbone_out_indices = tuple(backbone_out_indices)
        # read by the optimizer's labels
        self.frozen_stages, self.norm_eval = frozen_stages, norm_eval
        self.freeze_backbone_neck = freeze_backbone_neck
        self.dtype = dtype
        self.loss_cls_weight = loss_cls_weight
        self.loss_kpt_weight = loss_kpt_weight
        self.loss_kpt_rpn_weight = loss_kpt_rpn_weight
        self.loss_kpt_refine_weight = loss_kpt_refine_weight
        self.loss_oks_weight = loss_oks_weight
        self.loss_oks_refine_weight = loss_oks_refine_weight
        self.loss_hm_weight = loss_hm_weight
        self.cost_weights = dict(cls_weight=cls_cost_weight,
                                 kpt_weight=kpt_cost_weight,
                                 oks_weight=oks_cost_weight)
        if backbone_type == "swin":
            self.backbone = SwinTransformer(
                swin_embed_dims, swin_depths, swin_num_heads,
                swin_window_size, out_indices=backbone_out_indices,
                dtype=dtype)
        elif backbone_type == "hrnet":
            self.backbone = HRNet(hrnet_width, dtype)
        elif backbone_type == "resnet":
            self.backbone = ResNet(backbone_depth, backbone_out_indices,
                                   norm_eval, frozen_stages, dtype)
        else:
            raise KeyError(f"unsupported backbone_type {backbone_type!r}")
        widths = self.backbone.out_channels
        if backbone_type == "hrnet":     # the neck takes the chosen branches
            widths = tuple(widths[i] for i in self.backbone_out_indices)
        self.neck = ChannelMapper(widths, embed_dims, num_outs=4,
                                  dtype=dtype)
        self.head = VideoPoseHead(
            num_classes=num_classes, num_frames=num_frames,
            num_keypoints=num_keypoints, num_query=num_query,
            embed_dims=embed_dims, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            num_refine_layers=num_refine_layers,
            feedforward_channels=feedforward_channels, dropout=dropout,
            with_heatmap=with_heatmap,
            query_from_encoder_token=query_from_encoder_token,
            detach_decoder_refs=detach_decoder_refs,
            rle_flows=kpt_loss == "rle",
            encoder_mode=encoder_mode, impl=impl, dtype=dtype)
        self.register_buffer("oks_sigmas",
                             torch.tensor(OKS_SIGMAS[num_keypoints]),
                             persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights that follow the JAX initialisers wherever those fix
        a value (``jax_like_init_``)."""
        jax_like_init_(self, generator)

    # ------------------------------------------------------------------
    def extract_feats(self, img, train: bool = False):
        """(B, T, H, W, 3) -> list of (B, T, h, w, C); frames folded into the
        batch through backbone and neck (one BatchNorm reduction spans all
        B*T images, padding included); ``train`` puts trainable BatchNorm
        in train mode."""
        B, T, H, W, _ = img.shape
        x = img.reshape(B * T, H, W, 3).permute(0, 3, 1, 2)
        x = self.backbone(x, train)
        if self.backbone_type == "hrnet":
            x = [x[i] for i in self.backbone_out_indices]
        feats = self.neck(x)
        if self.freeze_backbone_neck:
            feats = [f.detach() for f in feats]
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

    def _head_inputs(self, img, img_shape, train=False):
        feats = self.extract_feats(img, train)
        level_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        mlvl_masks, valid_ratios = self.level_masks(
            img_shape, img.shape[2:4], level_shapes)
        return feats, mlvl_masks, valid_ratios

    def forward_outputs(self, img, img_shape, train: bool = False,
                        topk_idx=None, return_heatmap: bool = False):
        """The head's outputs (``train``: trainable BatchNorm in train
        mode; ``topk_idx``: the head's selection hook; ``return_heatmap``:
        PETR's heatmap branch too)."""
        feats, mlvl_masks, valid_ratios = self._head_inputs(img, img_shape,
                                                            train)
        outs = self.head(feats, mlvl_masks, valid_ratios, topk_idx,
                         return_heatmap)
        outs["valid_ratios"] = valid_ratios
        return outs

    def forward_memory(self, img, img_shape):
        """Backbone, neck and encoder only: ``memory`` (B, T, N, C),
        ``mask_flatten`` (B, N) and ``spatial_shapes`` (the encoder
        distillation's inputs; the decoders do not run)."""
        return self.head.forward_encoder(*self._head_inputs(img, img_shape))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def match(self, outs, batch):
        """Hungarian matching of every prediction set of ``outs``: the
        decoder layers in order, then the encoder proposals. Returns one
        ``PoseTargets`` per set; the costs cross to the host once."""
        K = self.num_keypoints
        sets = [(outs["all_cls_scores"][d], outs["all_kpt_preds"][d])
                for d in range(outs["all_cls_scores"].shape[0])]
        sets.append((outs["enc_cls_scores"], outs["enc_kpt_preds"]))
        with torch.no_grad():
            costs = [pose_match_cost(
                cls, kpt.unflatten(-1, (K, 2)),
                batch["gt_keypoints"], batch["gt_areas"], batch["img_shape"],
                self.oks_sigmas, **self.cost_weights) for cls, kpt in sets]
        query_idx = hungarian_assign(costs, batch["gt_valid"])
        return [build_pose_targets(
            idx, batch["gt_valid"], batch["gt_keypoints"], batch["gt_areas"],
            batch["img_shape"], cls.shape[1], self.num_classes)
            for idx, (cls, _) in zip(query_idx, sets)]

    def _gather_pos(self, preds, targets: PoseTargets):
        """Matched predictions per GT slot: (B, Q, 2K) -> (B, G, K, 2)."""
        B, K = preds.shape[0], self.num_keypoints
        idx = targets.query_idx.clamp(min=0)
        return torch.gather(preds.view(B, -1, K, 2), 1,
                            idx[..., None, None].expand(*idx.shape, K, 2))

    def _rle(self, flow, pred, sigma, targets: PoseTargets, num_valid_kpt,
             weight):
        """RLE loss of matched (B, G, K, 2) predictions and sigmas."""
        sigma = sigma.clamp(min=1e-4)
        w = targets.kpt_weights
        bar_mu = torch.where(w > 0, (pred - targets.kpt_targets) / sigma,
                             torch.zeros_like(pred))
        log_phi = flow.log_prob(bar_mu.reshape(-1, 2)).view(w.shape[:-1])
        return rle_loss(pred, sigma, targets.kpt_targets, w, log_phi,
                        num_valid_kpt, weight)

    def _cls_loss(self, cls_scores, targets: PoseTargets):
        """Focal loss (gamma 2, alpha 0.25) over all queries."""
        avg = targets.num_pos.sum().clamp(min=1.0)
        return sigmoid_focal_loss(
            cls_scores.reshape(-1, self.num_classes),
            targets.labels.reshape(-1), avg_factor=avg) * self.loss_cls_weight

    def _kpt(self, flow, pred, sigma, targets: PoseTargets, num_valid_kpt,
             weight):
        """The keypoint loss of matched (B, G, K, 2) predictions: RLE, or
        L1 (mmdet ``L1Loss`` over the visible keypoints' count)."""
        if self.kpt_loss == "rle":
            return self._rle(flow, pred, sigma, targets, num_valid_kpt,
                             weight)
        return ((pred - targets.kpt_targets).abs()
                * targets.kpt_weights).sum() / num_valid_kpt * weight

    def _oks(self, pred, targets: PoseTargets, img_shape, weight):
        """-log(OKS) of matched (B, G, K, 2) predictions in pixels, over
        the GT slots with a visible keypoint, averaged by the positives."""
        B, G, K = pred.shape[:3]
        factor = img_shape.flip(-1).to(pred.dtype)[:, None, None, :]
        pos_valid = targets.kpt_weights.sum((-1, -2)) > 0       # (B, G)
        return oks_loss(
            (pred * factor).reshape(B * G, -1),
            (targets.kpt_targets * factor).reshape(B * G, -1),
            targets.kpt_weights[..., 0].reshape(B * G, -1),
            targets.area_targets.clamp(min=1e-6).reshape(B * G),
            num_keypoints=K, weight=pos_valid.reshape(B * G).to(pred.dtype),
            avg_factor=targets.num_pos.sum().clamp(min=1.0)) * weight

    def _set_losses(self, flow, cls_scores, kpt_preds, sigma_preds,
                    targets: PoseTargets, kpt_weight, oks_weight, img_shape):
        """Focal, keypoint and (``oks_weight`` > 0) OKS losses of one
        prediction set; the OKS loss is None where unweighted."""
        num_valid_kpt = targets.kpt_weights.sum().clamp(min=1.0)
        pred = self._gather_pos(kpt_preds, targets)
        sigma = (self._gather_pos(sigma_preds, targets)
                 if self.kpt_loss == "rle" else None)
        oks = (self._oks(pred, targets, img_shape, oks_weight)
               if oks_weight > 0 else None)
        return (self._cls_loss(cls_scores, targets),
                self._kpt(flow, pred, sigma, targets, num_valid_kpt,
                          kpt_weight), oks)

    def _heatmap_loss(self, hm_pred, hm_mask, batch):
        """CornerNet's focal loss of the level-0 heatmap logits against
        ``heatmap_target`` over the unpadded cells."""
        pred = torch.sigmoid(hm_pred).clamp(1e-4, 1 - 1e-4)
        return center_focal_loss(pred, heatmap_target(batch, hm_pred.shape),
                                 mask=~hm_mask) * self.loss_hm_weight

    def forward_train(self, batch, topk_idx=None):
        """Loss dict of one batch, as the JAX ``forward_train``: per pose
        decoder layer (prefix ``d{i}.``, the last layer unprefixed) the
        focal, keypoint and weighted OKS losses, the encoder proposals over
        all N tokens (``enc_``), the weighted heatmap loss (``loss_hm``),
        the joint decoder on the last layer's matched poses
        (``d{r}.loss_kpt_refine``, ``d{r}.loss_oks_refine``), and their sum
        ``loss``. Trainable BatchNorm runs in train mode and updates its
        running statistics; ``topk_idx`` is the head's selection hook."""
        with_hm = self.head.with_heatmap and self.loss_hm_weight > 0
        outs = self.forward_outputs(batch["img"], batch["img_shape"],
                                    train=True, topk_idx=topk_idx,
                                    return_heatmap=with_hm)
        head = self.head
        img_shape = batch["img_shape"]
        *dec_targets, enc_targets = self.match(outs, batch)
        losses = {}
        D = len(dec_targets)
        for d, targets in enumerate(dec_targets):
            prefix = "" if d == D - 1 else f"d{d}."
            cls, kpt, oks = self._set_losses(
                head.dec_flow, outs["all_cls_scores"][d],
                outs["all_kpt_preds"][d], outs["all_sigma_preds"][d],
                targets, self.loss_kpt_weight, self.loss_oks_weight,
                img_shape)
            losses[prefix + "loss_cls"], losses[prefix + "loss_kpt"] = cls, kpt
            if oks is not None:
                losses[prefix + "loss_oks"] = oks
        losses["enc_loss_cls"], losses["enc_loss_kpt"], _ = self._set_losses(
            head.enc_flow, outs["enc_cls_scores"], outs["enc_kpt_preds"],
            outs["enc_sigma_preds"], enc_targets, self.loss_kpt_rpn_weight,
            0.0, img_shape)
        if with_hm:
            losses["loss_hm"] = self._heatmap_loss(outs["hm_pred"],
                                                   outs["hm_mask"], batch)

        # joint decoder on the matched poses of the last layer, detached
        last = dec_targets[-1]
        frame_preds = outs["frame_kpt_preds"]                # (B,T,Q,2K)
        B, T = frame_preds.shape[:2]
        idx = last.query_idx.clamp(min=0)                    # (B, G)
        ref_poses = torch.gather(frame_preds, 2, idx[:, None, :, None].expand(
            B, T, idx.shape[1], frame_preds.shape[-1])).transpose(1, 2)
        refine_kpts, _, refine_sigmas = head.forward_refine(
            outs["memory"], outs["mask_flatten"], outs["valid_ratios"],
            ref_poses.detach(), outs["spatial_shapes"])
        num_valid_kpt = last.kpt_weights.sum().clamp(min=1.0)
        for r in range(refine_kpts.shape[0]):
            losses[f"d{r}.loss_kpt_refine"] = self._kpt(
                head.flow, refine_kpts[r], refine_sigmas[r], last,
                num_valid_kpt, self.loss_kpt_refine_weight)
            if self.loss_oks_refine_weight > 0:
                losses[f"d{r}.loss_oks_refine"] = self._oks(
                    refine_kpts[r], last, img_shape,
                    self.loss_oks_refine_weight)
        losses["loss"] = sum(losses.values())
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_test(self, batch, topk_idx=None, with_nms=None):
        """Padded detections per image, in the original image's pixels:
        det_kpts (B, M, K, 3) (the third channel the Poseur keypoint
        score, or 1 without ``with_rescoring``), det_bboxes (B, M, 5),
        det_labels (B, M), keep (B, M) (OKS-NMS; all True without NMS).
        ``with_nms`` None follows the model's; ``topk_idx``: the head's
        selection hook, as in ``forward_outputs``."""
        if with_nms is None:
            with_nms = self.with_nms
        outs = self.forward_outputs(batch["img"], batch["img_shape"],
                                    topk_idx=topk_idx)
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

        if self.with_rescoring:   # Poseur: p_x = 0.2, * 0.7, power 5
            p = 1.0 - torch.exp(-(0.2 / det_sigmas.clamp(min=1e-6)))
            p = (p[..., 0] * p[..., 1])[..., None] * 0.7          # (B,M,K,1)
            det_kpts = det_kpts * p ** 5 / (p ** 5 + 1e-10)
            kpt_scores = scores[:, :, None, None] * p
        else:                     # PETR: unit keypoint scores
            kpt_scores = torch.ones_like(det_kpts[..., :1])
        det_kpts = torch.cat([det_kpts, kpt_scores], -1)

        if with_nms:
            areas = ((det_kpts[..., 0].amax(-1) - det_kpts[..., 0].amin(-1))
                     * (det_kpts[..., 1].amax(-1)
                        - det_kpts[..., 1].amin(-1)))
            keep = torch.stack([
                oks_nms_keep(det_kpts[b, ..., :2], scores[b], areas[b],
                             self.oks_sigmas)
                for b in range(B)])
        else:
            keep = torch.ones((B, M), dtype=torch.bool, device=scores.device)
        return dict(det_kpts=det_kpts, det_bboxes=det_bboxes,
                    det_labels=torch.zeros((B, M), dtype=torch.int32,
                                           device=scores.device),
                    keep=keep)

    # ------------------------------------------------------------------
    # test-time augmentation
    # ------------------------------------------------------------------
    @staticmethod
    def _flip_images(batch):
        """Horizontal flip inside each sample's valid width (the images
        are padded right and bottom to the bucket, so a flip across the
        bucket would move content into the padding)."""
        img = batch["img"]                                 # (B, T, H, W, 3)
        W = img.shape[3]
        img_w = batch["img_shape"][:, 1].long()
        xs = torch.arange(W, device=img.device)
        src = torch.where(xs[None] < img_w[:, None],
                          img_w[:, None] - 1 - xs[None], xs[None])  # (B, W)
        idx = src[:, None, None, :, None].expand(img.shape)
        return dict(batch, img=torch.gather(img, 3, idx))

    def _flipped_back(self, batch, topk_idx=None):
        """``forward_test`` without NMS on the flipped clip, keypoints mapped
        back into the original orientation (x -> original width - x, left
        and right swapped)."""
        out = self.forward_test(self._flip_images(batch), topk_idx=topk_idx,
                                with_nms=False)
        ori_w = (batch["img_shape"][:, 1].float()
                 / batch["scale_factor"][:, 0])
        kpts = out["det_kpts"]                             # (B, M, K, 3)
        kpts = torch.cat([(ori_w[:, None, None] - kpts[..., 0])[..., None],
                          kpts[..., 1:]], -1)
        perm = list(range(self.num_keypoints))
        for a, b in FLIP_PAIRS_BY_K.get(self.num_keypoints, ()):
            perm[a], perm[b] = perm[b], perm[a]
        return kpts[:, :, perm], out["det_bboxes"][..., 4]

    def _merge(self, kpts, scores):
        """Union of passes -> box NMS on the keypoints' boxes -> the best
        ``max_per_img`` kept entries, keypoint scores reset to 1; ``keep``
        marks the finite (kept) slots."""
        boxes = torch.stack([kpts[..., 0].amin(-1), kpts[..., 1].amin(-1),
                             kpts[..., 0].amax(-1), kpts[..., 1].amax(-1)],
                            -1)                            # (B, nM, 4)
        keep = torch.stack([box_nms_keep(b, s, TTA_NMS_IOU)
                            for b, s in zip(boxes, scores)])
        ranked = torch.where(keep, scores,
                             torch.full_like(scores, -float("inf")))
        top_scores, top_idx = ranked.topk(self.max_per_img, dim=1)
        det_kpts = torch.gather(kpts, 1, top_idx[..., None, None].expand(
            *top_idx.shape, *kpts.shape[2:]))
        det_kpts = torch.cat([det_kpts[..., :2],
                              torch.ones_like(det_kpts[..., :1])], -1)
        det_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(
            *top_idx.shape, 4))
        return dict(det_kpts=det_kpts,
                    det_bboxes=torch.cat([det_boxes, top_scores[..., None]],
                                         -1),
                    det_labels=torch.zeros(top_idx.shape, dtype=torch.int32,
                                           device=top_idx.device),
                    keep=torch.isfinite(top_scores))

    @torch.no_grad()
    def forward_test_flip(self, batch):
        """Flip test: the clip and its flip, each without OKS-NMS, merged by
        box NMS (the reference's ``aug_test``). The output is
        ``forward_test``'s."""
        out = self.forward_test(batch, with_nms=False)
        kpts_f, scores_f = self._flipped_back(batch)
        return self._merge(torch.cat([out["det_kpts"], kpts_f], 1),
                           torch.cat([out["det_bboxes"][..., 4], scores_f],
                                     1))

    @torch.no_grad()
    def forward_test_aug(self, batch, flip: bool = False, topk_idx=None):
        """One pass of test-time augmentation: ``det_kpts`` (B, M, K, 3) in
        the original image's pixels and ``scores`` (B, M), no NMS;
        ``flip`` runs the flipped clip and maps it back. Merge the passes
        with ``merge_aug_detections``. ``topk_idx``: the head's selection
        hook for the clip the pass runs (the flipped one with ``flip``)."""
        if flip:
            kpts, scores = self._flipped_back(batch, topk_idx)
            return dict(det_kpts=kpts, scores=scores)
        out = self.forward_test(batch, topk_idx=topk_idx, with_nms=False)
        return dict(det_kpts=out["det_kpts"],
                    scores=out["det_bboxes"][..., 4])

    @torch.no_grad()
    def merge_aug_detections(self, outs):
        """``forward_test_aug`` passes merged: union, box NMS, the best
        ``max_per_img`` (the reference's ``merge_aug_results`` and
        ``multiclass_nms``). The output is ``forward_test``'s."""
        return self._merge(torch.cat([o["det_kpts"] for o in outs], 1),
                           torch.cat([o["scores"] for o in outs], 1))
