"""PAVE-Net detector, frozen from the port's
``models/detectors/videopose.py``: backbone (ResNet or Swin) + neck +
video pose head, with the train step's losses (``forward_train``:
Hungarian matching, focal and RLE keypoint losses) and the test path's
Poseur rescoring and OKS-NMS (``forward_test``). Float32 throughout; the
backbone's norms are frozen (``norm_eval``), so ``nn.Module.training``
drives dropout alone.

Batch dict (tensors on the model's device):
    img:          (B, T, H, W, 3) float32, normalised
    img_shape:    (B, 2) int (valid h, w) before padding
    scale_factor: (B, 2) float32 (w_scale, h_scale) test-time rescale
    gt_keypoints: (B, G, K, 3) xyv, unnormalised (train)
    gt_areas:     (B, G) float32 (train)
    gt_valid:     (B, G) bool (train)
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..backbones.resnet import ResNet
from ..backbones.swin import SwinTransformer
from ..necks.channel_mapper import ChannelMapper
from ..dense_heads.videopose_head import VideoPoseHead
from ..losses import OKS_SIGMAS, rle_loss, sigmoid_focal_loss
from ...core.assigner import (PoseTargets, build_pose_targets,
                              hungarian_assign, pose_match_cost)
from ...ops.nms import oks_nms_keep


class VideoPoseDetector(nn.Module):
    """Flagship video model (T=3, K=15, R50); ``backbone_type`` 'swin'
    takes a Swin Transformer (Swin-L by default) in place of the
    ResNet."""

    def __init__(self, num_frames: int = 3, num_keypoints: int = 15,
                 num_classes: int = 1, num_query: int = 300,
                 backbone_type: str = "resnet", backbone_depth: int = 50,
                 backbone_out_indices: Tuple[int, ...] = (1, 2, 3),
                 swin_embed_dims: int = 192,
                 swin_depths: Tuple[int, ...] = (2, 2, 18, 2),
                 swin_num_heads: Tuple[int, ...] = (6, 12, 24, 48),
                 swin_window_size: int = 7,
                 embed_dims: int = 256, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 3, num_refine_layers: int = 2,
                 feedforward_channels: int = 1024, dropout: float = 0.1,
                 max_per_img: int = 20, frozen_stages: int = 1,
                 loss_cls_weight: float = 0.5, loss_kpt_weight: float = 1.0,
                 loss_kpt_rpn_weight: float = 1.0,
                 loss_kpt_refine_weight: float = 1.0,
                 cls_cost_weight: float = 2.0, kpt_cost_weight: float = 70.0,
                 oks_cost_weight: float = 7.0):
        super().__init__()
        self.num_frames, self.num_keypoints = num_frames, num_keypoints
        self.num_classes = num_classes
        self.max_per_img = max_per_img
        self.backbone_type = backbone_type
        self.backbone_out_indices = tuple(backbone_out_indices)
        # read by the optimizer's labels
        self.frozen_stages = frozen_stages
        self.loss_cls_weight = loss_cls_weight
        self.loss_kpt_weight = loss_kpt_weight
        self.loss_kpt_rpn_weight = loss_kpt_rpn_weight
        self.loss_kpt_refine_weight = loss_kpt_refine_weight
        self.cost_weights = dict(cls_weight=cls_cost_weight,
                                 kpt_weight=kpt_cost_weight,
                                 oks_weight=oks_cost_weight)
        if backbone_type == "swin":
            self.backbone = SwinTransformer(
                swin_embed_dims, swin_depths, swin_num_heads,
                swin_window_size, out_indices=backbone_out_indices)
        elif backbone_type == "resnet":
            self.backbone = ResNet(backbone_depth, backbone_out_indices,
                                   frozen_stages)
        else:
            raise KeyError(f"unsupported backbone_type {backbone_type!r}")
        widths = self.backbone.out_channels
        self.neck = ChannelMapper(widths, embed_dims, num_outs=4)
        self.head = VideoPoseHead(
            num_classes=num_classes, num_frames=num_frames,
            num_keypoints=num_keypoints, num_query=num_query,
            embed_dims=embed_dims, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            num_refine_layers=num_refine_layers,
            feedforward_channels=feedforward_channels, dropout=dropout)
        self.register_buffer("oks_sigmas",
                             torch.tensor(OKS_SIGMAS[num_keypoints]),
                             persistent=False)

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

    def forward_outputs(self, img, img_shape, topk_idx=None):
        """The head's outputs (``topk_idx``: the head's selection hook)."""
        feats = self.extract_feats(img)
        level_shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        mlvl_masks, valid_ratios = self.level_masks(
            img_shape, img.shape[2:4], level_shapes)
        outs = self.head(feats, mlvl_masks, valid_ratios, topk_idx)
        outs["valid_ratios"] = valid_ratios
        return outs

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def match(self, outs, batch, assign=None, record=None):
        """Hungarian matching of every prediction set of ``outs``: the
        decoder layers in order, then the encoder proposals. Returns one
        ``PoseTargets`` per set; the costs cross to the host once.
        ``assign`` (one ``(B, G)`` query index per set) replaces the
        solver's; ``record`` (a dict) gets the cost matrices."""
        K = self.num_keypoints
        sets = [(outs["all_cls_scores"][d], outs["all_kpt_preds"][d])
                for d in range(outs["all_cls_scores"].shape[0])]
        sets.append((outs["enc_cls_scores"], outs["enc_kpt_preds"]))
        with torch.no_grad():
            costs = [pose_match_cost(
                cls, kpt.unflatten(-1, (K, 2)),
                batch["gt_keypoints"], batch["gt_areas"], batch["img_shape"],
                self.oks_sigmas, **self.cost_weights) for cls, kpt in sets]
        if record is not None:
            record["costs"] = costs
        query_idx = (hungarian_assign(costs, batch["gt_valid"])
                     if assign is None else
                     [a.to(batch["gt_valid"].device) for a in assign])
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

    def _set_losses(self, flow, cls_scores, kpt_preds, sigma_preds,
                    targets: PoseTargets, kpt_weight):
        """Focal and RLE keypoint losses of one prediction set."""
        num_valid_kpt = targets.kpt_weights.sum().clamp(min=1.0)
        pred = self._gather_pos(kpt_preds, targets)
        sigma = self._gather_pos(sigma_preds, targets)
        return (self._cls_loss(cls_scores, targets),
                self._rle(flow, pred, sigma, targets, num_valid_kpt,
                          kpt_weight))

    def forward_train(self, batch, topk_idx=None, assign=None,
                      record=None):
        """Loss dict of one batch, as the JAX ``forward_train``: per pose
        decoder layer (prefix ``d{i}.``, the last layer unprefixed) the
        focal and RLE keypoint losses, the encoder proposals over all N
        tokens (``enc_``), the joint decoder on the last layer's matched
        poses (``d{r}.loss_kpt_refine``), and their sum ``loss``.
        ``topk_idx`` is the head's selection hook, ``assign`` the
        matching's (``match``); ``record`` (a dict) gets the proposal
        scores the top-k ranks (``topk_scores``) and the costs."""
        outs = self.forward_outputs(batch["img"], batch["img_shape"],
                                    topk_idx=topk_idx)
        head = self.head
        if record is not None:
            record["topk_scores"] = outs["topk_scores"]
            record["topk_idx"] = outs["topk_idx"]
        *dec_targets, enc_targets = self.match(outs, batch, assign, record)
        if record is not None:
            record["assign"] = [t.query_idx for t in dec_targets] + [
                enc_targets.query_idx]
        losses = {}
        D = len(dec_targets)
        for d, targets in enumerate(dec_targets):
            prefix = "" if d == D - 1 else f"d{d}."
            losses[prefix + "loss_cls"], losses[prefix + "loss_kpt"] = (
                self._set_losses(
                    head.dec_flow, outs["all_cls_scores"][d],
                    outs["all_kpt_preds"][d], outs["all_sigma_preds"][d],
                    targets, self.loss_kpt_weight))
        losses["enc_loss_cls"], losses["enc_loss_kpt"] = self._set_losses(
            head.enc_flow, outs["enc_cls_scores"], outs["enc_kpt_preds"],
            outs["enc_sigma_preds"], enc_targets, self.loss_kpt_rpn_weight)

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
            losses[f"d{r}.loss_kpt_refine"] = self._rle(
                head.flow, refine_kpts[r], refine_sigmas[r], last,
                num_valid_kpt, self.loss_kpt_refine_weight)
        losses["loss"] = sum(losses.values())
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_test(self, batch, topk_idx=None, with_nms=True,
                     select=None, record=None):
        """Padded detections per image, in the original image's pixels:
        det_kpts (B, M, K, 3) (the third channel the Poseur keypoint
        score), det_bboxes (B, M, 5), det_labels (B, M), keep (B, M)
        (OKS-NMS; all True with ``with_nms`` False); ``topk_idx``: the head's
        selection hook, as in ``forward_outputs``; ``select`` (B, M') the
        queries to return in place of the ``max_per_img`` best;
        ``record`` (a dict) gets the proposal scores the top-k ranks."""
        outs = self.forward_outputs(batch["img"], batch["img_shape"],
                                    topk_idx=topk_idx)
        if record is not None:
            record["topk_scores"] = outs["topk_scores"]
            record["topk_idx"] = outs["topk_idx"]
        B = batch["img"].shape[0]
        K = self.num_keypoints

        cls_score = outs["all_cls_scores"][-1][..., 0].sigmoid()
        if select is None:
            scores, bbox_index = cls_score.topk(self.max_per_img, dim=1)
        else:
            bbox_index, scores = select, cls_score.gather(1, select)
        M = bbox_index.shape[1]
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
        kpt_scores = scores[:, :, None, None] * p
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
