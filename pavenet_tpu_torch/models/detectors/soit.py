"""SOIT and DK-DETR (as ``pavenet_tpu/models/detectors/soit.py``): a
two-stage, box-refining deformable DETR whose decoder also emits, per
query, 441 dynamic parameters of a per-instance deformable attention over
an 8-channel mask feature (the level-0 memory through a one-head seg
encoder), with a box-centre-relative sine position encoding.

DK-DETR is the same detector with ``cls_emb_dim`` > 0: the decoder's class
branches emit embeddings scored by cosine similarity against the batch's
``text_feats`` (one row per class) over ``temperature``; the encoder's
proposal branch still scores ``num_classes``. Its backbone trains its
BatchNorm (``norm_eval=False``); train mode only in ``forward_train``, as
in ``VideoPoseDetector``. Dropout follows ``nn.Module.training``.

The per-instance masks run batched: the instances of an image fold into
the query axis of one msda call over the image's mask feature, which they
share. That call takes the model's ``impl``, as every other msda call does
(on the card the hand-written kernels at 4 heads of 2 channels, where the
JAX package takes its XLA gather, ``impl='xla'``).

Over ``torch.distributed`` ranks the box and mask losses divide by the
global batch's valid GT count (``parallel/dist.py::global_sum``).

Batch dict (tensors on the model's device):
    img:          (B, H, W, 3) float32, normalised
    img_shape:    (B, 2) int (valid h, w) before padding
    scale_factor: (B, 2) float32 (w_scale, h_scale) test-time rescale
    text_feats:   (C', text_dim) DK-DETR's class embeddings
    gt_boxes:     (B, G, 4) xyxy in pixels (train)
    gt_labels:    (B, G) int class index (train)
    gt_masks:     (B, G, h, w) binary masks, any size (train)
    gt_valid:     (B, G) bool (train)
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..attention.deformable import (MultiScaleDeformableAttention,
                                    make_sampling_locations)
from ..backbones.resnet import ResNet
from ..dense_heads.videopose_head import (EncoderLayer, VideoPoseHead,
                                          bias_init_with_prob,
                                          inverse_sigmoid)
from ..layers.dtype import LayerNorm, Linear
from ..layers.positional_encoding import sine_positional_encoding
from ..layers.transformer import FFN, MLP, MultiheadAttention
from ..losses import sigmoid_focal_loss
from ..necks.channel_mapper import ChannelMapper
from ...core.assigner import hungarian_assign
from ...ops.ms_deform_attn import ms_deform_attn
from ...parallel.dist import global_sum
from .videopose import VideoPoseDetector, jax_like_init_

Shapes = Tuple[Tuple[int, int], ...]


# ---------------------------------------------------------------- box utils
def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def giou(boxes1, boxes2, eps: float = 1e-7):
    """Generalised IoU of xyxy boxes, broadcasting ``(..., 4)``."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((boxes1[..., 2] - boxes1[..., 0])
          * (boxes1[..., 3] - boxes1[..., 1]))
    a2 = ((boxes2[..., 2] - boxes2[..., 0])
          * (boxes2[..., 3] - boxes2[..., 1]))
    union = a1 + a2 - inter + eps
    iou = inter / union
    lt_e = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_e = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_e = (rb_e - lt_e).clamp(min=0.0)
    enclose = wh_e[..., 0] * wh_e[..., 1] + eps
    return iou - (enclose - union) / enclose


def rel_sine_positional_encoding(mask, center, num_feats: int = 4,
                                 temperature: float = 10000.0,
                                 scale: float = 2 * math.pi,
                                 eps: float = 1e-6):
    """Box-centre-relative sine encoding of every instance of an image.

    mask ``(B, h, w)`` bool, True = pad; center ``(B, M, 2)`` normalised
    (cx, cy). Returns ``(B, M, h, w, 2 * num_feats)`` float32, channels
    ``[y, x]`` with interleaved sin/cos."""
    not_mask = (~mask).float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = y / (y[:, -1:, :] + eps)
    x = x / (x[:, :, -1:] + eps)
    center = center.float()
    y = (y[:, None] - center[..., 1, None, None]) * scale
    x = (x[:, None] - center[..., 0, None, None]) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                     -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                     -1).flatten(-2)
    return torch.cat([py, px], -1)


def aligned_bilinear(x, factor: int):
    """CondInst's aligned upsample: replicate-pad right and bottom by 1,
    resize to ``(f*h+1, f*w+1)`` with align_corners=True, replicate-pad
    left and top by ``f//2``, crop. x ``(..., h, w)``."""
    h, w = x.shape[-2:]
    x = torch.cat([x, x[..., -1:, :]], -2)
    x = torch.cat([x, x[..., :, -1:]], -1)
    oh, ow = factor * h + 1, factor * w + 1
    dev = x.device
    yy = torch.arange(oh, dtype=torch.float32, device=dev) * (h / (oh - 1))
    xx = torch.arange(ow, dtype=torch.float32, device=dev) * (w / (ow - 1))
    y0 = yy.floor().long().clamp(0, h - 1)
    x0 = xx.floor().long().clamp(0, w - 1)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    rows0, rows1 = x[..., y0, :], x[..., y0 + 1, :]
    g, gx = rows0[..., x0], rows0[..., x0 + 1]
    gy, gyx = rows1[..., x0], rows1[..., x0 + 1]
    out = (g * (1 - fy) * (1 - fx) + gy * fy * (1 - fx)
           + gx * (1 - fy) * fx + gyx * fy * fx)
    pad = factor // 2
    out = torch.cat([out[..., :1, :].expand(*out.shape[:-2], pad,
                                            out.shape[-1]), out], -2)
    out = torch.cat([out[..., :, :1].expand(*out.shape[:-1], pad), out], -1)
    return out[..., : oh - 1, : ow - 1]


# ------------------------------------------------------------ dynamic mask
DYN_SPLITS = dict(off_w=(0, 256), off_b=(256, 288), att_w=(288, 416),
                  att_b=(416, 432), out_w=(432, 440), out_b=(440, 441))


DYN_HEADS, DYN_POINTS = 4, 4


def dynamic_mask_attention(params, mask_feat, pos_embed, token_refs,
                           spatial_shape, key_padding_mask,
                           impl: str = "auto"):
    """Per-instance dynamic deformable attention over the mask feature:
    the 441 parameters of each instance are its 1x1 convs for the sampling
    offsets (8 -> 32), the attention weights (8 -> 16) and the output
    logit (8 -> 1).

    params ``(B, M, 441)``; mask_feat ``(B, n0, 8)``, shared by the
    image's instances; pos_embed ``(B, M, n0, 8)``; token_refs ``(B, n0,
    1, 2)``; key_padding_mask ``(B, n0)``. The M instances fold into the
    query axis of one msda call per batch: ``(B, M * n0)`` queries over
    the image's value, which is neither expanded nor copied: 4 heads of 2
    channels, one level, 4 points, through ``ms_deform_attn``'s ``impl``
    ('auto': the kernels on the card, the plain version on the CPU).
    Returns logits ``(B, M, n0)``."""
    B, M, _ = params.shape
    n0, C = mask_feat.shape[1:]
    q = mask_feat[:, None] + pos_embed                     # (B, M, n0, C)
    dt = torch.promote_types(q.dtype, params.dtype)
    q, params = q.to(dt), params.to(dt)

    def part(name, *shape):
        lo, hi = DYN_SPLITS[name]
        return params[..., lo:hi].reshape(B, M, *shape)

    offsets = (torch.einsum("bmnc,bmoc->bmno", q, part("off_w", 32, C))
               + part("off_b", 1, 32))
    weights = (torch.einsum("bmnc,bmoc->bmno", q, part("att_w", 16, C))
               + part("att_b", 1, 16))
    H, P = DYN_HEADS, DYN_POINTS
    offsets = offsets.reshape(B, M * n0, H, 1, P, 2)
    weights = weights.reshape(B, M * n0, H, P).softmax(-1)
    weights = weights.view(B, M * n0, H, 1, P)
    value = mask_feat.masked_fill(key_padding_mask[..., None], 0.0)
    value = value.view(B, n0, H, C // H)
    refs = token_refs[:, None].expand(B, M, n0, 1, 2).reshape(B, M * n0, 1,
                                                               2)
    locations = make_sampling_locations(refs, offsets, (spatial_shape,), P)
    out = ms_deform_attn(value, (spatial_shape,), locations, weights,
                         impl=impl).view(B, M, n0, C)
    out = F.relu(out).to(dt)
    return (torch.einsum("bmnc,bmc->bmn", out, part("out_w", C))
            + part("out_b", 1))


# ---------------------------------------------------------------- detector
class SOITDetector(nn.Module):
    """SOIT R50 (``configs/soit/soit_r50_16x2_50e_coco.py``); DK-DETR with
    ``cls_emb_dim`` > 0. ``dropout`` is 0.1 by default, the value the JAX
    module fixes."""

    num_frames = 1
    freeze_backbone_neck = False
    # the stem and stage 1 stay frozen: the JAX module's ResNet default and
    # every config's value (read by the optimizer's labels too)
    frozen_stages = 1

    def __init__(self, num_classes: int = 80, num_query: int = 300,
                 max_gt: int = 30, backbone_depth: int = 50,
                 norm_eval: bool = True, embed_dims: int = 256,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 feedforward_channels: int = 1024, num_heads: int = 8,
                 num_levels: int = 4, mask_channels: int = 8,
                 dynamic_params_dims: int = 441, max_per_img: int = 100,
                 loss_cls_weight: float = 2.0, loss_bbox_weight: float = 5.0,
                 loss_iou_weight: float = 2.0,
                 dice_mask_loss_weight: float = 1.0,
                 bce_mask_loss_weight: float = 1.0,
                 cls_cost_weight: float = 2.0, reg_cost_weight: float = 5.0,
                 iou_cost_weight: float = 2.0, cls_emb_dim: int = 0,
                 temperature: float = 1.0, dropout: float = 0.1,
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        C = embed_dims
        self.impl = impl    # the dynamic mask call's; the layers keep theirs
        self.num_classes, self.num_query = num_classes, num_query
        self.max_gt, self.max_per_img = max_gt, max_per_img
        self.embed_dims = C
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.mask_channels = mask_channels
        self.cls_emb_dim, self.temperature = cls_emb_dim, temperature
        self.norm_eval = norm_eval    # read by the optimizer's labels
        self.loss_weights = dict(cls=loss_cls_weight, bbox=loss_bbox_weight,
                                 iou=loss_iou_weight,
                                 dice=dice_mask_loss_weight,
                                 bce=bce_mask_loss_weight)
        self.cost_weights = dict(cls=cls_cost_weight, reg=reg_cost_weight,
                                 iou=iou_cost_weight)
        d = dtype
        self.backbone = ResNet(backbone_depth, (1, 2, 3), norm_eval,
                               self.frozen_stages, d)
        self.neck = ChannelMapper(self.backbone.out_channels, C,
                                  num_outs=num_levels, dtype=d)
        add = self.add_module
        for i in range(num_encoder_layers):
            add(f"encoder_layer{i}", EncoderLayer(
                C, num_heads, num_levels, 4, feedforward_channels, dropout,
                impl, d))
        # the seg encoder: one head over level 0 alone
        self.seg_encoder_layer = EncoderLayer(C, 1, 1, 4,
                                              feedforward_channels, dropout,
                                              impl, d)
        self.mask_trans = Linear(C, mask_channels, dtype=d)
        self.mask_trans_norm = LayerNorm(mask_channels, dtype=d)
        self.level_embeds = nn.Parameter(torch.empty(num_levels, C))
        self.enc_output = Linear(C, C, dtype=d)
        self.enc_output_norm = LayerNorm(C, dtype=d)
        self.pos_trans = Linear(2 * C, 2 * C, dtype=d)
        self.pos_trans_norm = LayerNorm(2 * C, dtype=d)
        for i in range(num_decoder_layers):
            add(f"dec_self_attn{i}", MultiheadAttention(C, num_heads, dropout,
                                                        d))
            add(f"dec_cross_attn{i}", MultiScaleDeformableAttention(
                C, num_heads, num_levels, 4, dropout, impl, d))
            for j in (1, 2, 3):
                add(f"dec_norm{j}_{i}", LayerNorm(C, dtype=d))
            add(f"dec_ffn{i}", FFN(C, feedforward_channels, dropout, d))
        num_pred = num_decoder_layers + 1
        for i in range(num_pred):
            # the last branch, the encoder proposals', scores num_classes
            out = (cls_emb_dim or num_classes) if i < num_pred - 1 \
                else num_classes
            add(f"cls_branch{i}", Linear(C, out, dtype=d))
            add(f"reg_branch{i}", MLP(C, (C, C), 4, zero_init_last=True,
                                      dtype=d))
            if i < num_pred - 1:
                add(f"seg_branch{i}", MLP(C, (C, C), dynamic_params_dims,
                                          dtype=d))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights that follow the JAX initialisers' fixed values
        (``videopose.jax_like_init_``)."""
        jax_like_init_(self, generator)

    def init_fixed_(self, generator):
        nn.init.normal_(self.level_embeds, 0.0, 1.0, generator=generator)
        for i in range(self.num_decoder_layers + 1):
            nn.init.constant_(getattr(self, f"cls_branch{i}").bias,
                              bias_init_with_prob(0.01))

    def _m(self, name, *idx):
        return getattr(self, name.format(*idx))

    # ------------------------------------------------------------ forward
    def _text_logits(self, emb, text_feats):
        """Cosine similarity over the temperature."""
        e = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        t = text_feats / text_feats.norm(dim=-1, keepdim=True).clamp(
            min=1e-6)
        return (e @ t.to(e.dtype).T) / self.temperature

    def _proposal_pos_embed(self, coords, temperature: float = 10000.0):
        num_feats = self.embed_dims // 2
        dim_t = torch.arange(num_feats, dtype=torch.float32,
                             device=coords.device)
        dim_t = temperature ** (2 * (dim_t // 2) / num_feats)
        pos = coords.sigmoid()[..., None] * (2 * math.pi) / dim_t
        pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], -1)
        return pos.reshape(*coords.shape[:-1], -1)

    def forward_outputs(self, img, img_shape, train: bool = False,
                        text_feats=None, topk_idx=None):
        """The detector's outputs on ``img`` (B, H, W, 3). ``train`` puts
        trainable BatchNorm in train mode. ``topk_idx`` (B, num_query), if
        given, replaces the proposals' top-k (a check's hook past a tie);
        the selection made is returned as ``topk_idx``."""
        B, H, W, _ = img.shape
        x = self.backbone(img.permute(0, 3, 1, 2), train)
        feats = [f.permute(0, 2, 3, 1) for f in self.neck(x)]
        shapes: Shapes = tuple((int(f.shape[1]), int(f.shape[2]))
                               for f in feats)
        mlvl_masks, valid_ratios = VideoPoseDetector.level_masks(
            img_shape, (H, W), shapes)
        C = self.embed_dims
        feat_flat, mask_flat, pos_flat = [], [], []
        for lvl, (f, m) in enumerate(zip(feats, mlvl_masks)):
            h, w = shapes[lvl]
            feat_flat.append(f.reshape(B, h * w, C))
            mask_flat.append(m.reshape(B, h * w))
            pos = sine_positional_encoding(m, num_feats=C // 2).to(f.dtype)
            pos_flat.append(pos.reshape(B, h * w, C)
                            + self.level_embeds[lvl][None, None])
        x = torch.cat(feat_flat, 1)
        mask = torch.cat(mask_flat, 1)
        pos = torch.cat(pos_flat, 1)

        enc_ref = VideoPoseHead.encoder_reference_points(shapes, valid_ratios)
        for i in range(self.num_encoder_layers):
            x = self._m("encoder_layer{}", i)(x, pos, enc_ref, shapes, mask)
        memory = x

        # the mask feature: the seg encoder over level-0 memory
        n0 = shapes[0][0] * shapes[0][1]
        token_refs = enc_ref[:, :n0, :1]
        seg = self.seg_encoder_layer(memory[:, :n0], pos[:, :n0], token_refs,
                                     (shapes[0],), mask[:, :n0])
        mask_feat = self.mask_trans_norm(self.mask_trans(seg))

        # two-stage box proposals
        level_wh = torch.tensor([[[w, h] for h, w in shapes]],
                                dtype=torch.float32, device=mask.device)
        prop_logit, prop_valid = VideoPoseHead.gen_proposals(
            shapes, valid_ratios * level_wh, mask)
        out_mem = memory.masked_fill(~prop_valid[..., None], 0.0)
        out_mem = self.enc_output_norm(self.enc_output(out_mem))
        last = self.num_decoder_layers
        enc_cls = self._m("cls_branch{}", last)(out_mem)
        enc_delta = self._m("reg_branch{}", last)(out_mem)
        # proposal wh = 0.05 * 2^lvl in sigmoid space, 1e6 where invalid
        wh_logit = torch.cat([
            torch.full((B, hh * ww, 2), math.log(0.05 * 2.0 ** lvl
                                                 / (1 - 0.05 * 2.0 ** lvl)),
                       dtype=torch.float32, device=mask.device)
            for lvl, (hh, ww) in enumerate(shapes)], 1)
        wh_logit = wh_logit.masked_fill(~prop_valid[..., None], 1e6)
        enc_coord_unact = enc_delta + torch.cat([prop_logit, wh_logit], -1)
        # the top-k scores the FIRST class logit (mmdet's two-stage rule)
        if topk_idx is None:
            topk_scores = torch.where(prop_valid, enc_cls[..., 0],
                                      torch.full_like(enc_cls[..., 0], -1e4))
            topk_idx = topk_scores.topk(self.num_query, dim=1).indices
        topk_coords = torch.gather(enc_coord_unact, 1, topk_idx[..., None]
                                   .expand(B, self.num_query, 4)).detach()
        ref = topk_coords.sigmoid()                         # (B, Q, 4)
        pt = self.pos_trans_norm(self.pos_trans(
            self._proposal_pos_embed(topk_coords)))
        query_pos, query = pt.split(C, -1)

        vr4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
        inter_cls, inter_coords, inter_dyn = [], [], []
        for lid in range(self.num_decoder_layers):
            query = self._m("dec_self_attn{}", lid)(query, query_pos)
            query = self._m("dec_norm1_{}", lid)(query)
            query = self._m("dec_cross_attn{}", lid)(
                query, memory, ref[:, :, None, :] * vr4, shapes,
                key_padding_mask=mask, query_pos=query_pos)
            query = self._m("dec_norm2_{}", lid)(query)
            query = self._m("dec_ffn{}", lid)(query)
            query = self._m("dec_norm3_{}", lid)(query)
            # box refinement; the next layer takes the refined box detached
            new_ref = (self._m("reg_branch{}", lid)(query)
                       + inverse_sigmoid(ref)).sigmoid()
            inter_cls.append(self._m("cls_branch{}", lid)(query))
            inter_coords.append(new_ref)
            inter_dyn.append(self._m("seg_branch{}", lid)(query))
            ref = new_ref.detach()

        if self.cls_emb_dim:
            if text_feats is None:
                raise ValueError("DK-DETR needs batch['text_feats']")
            inter_cls = [self._text_logits(c, text_feats) for c in inter_cls]
        return dict(
            all_cls_scores=torch.stack(inter_cls),
            all_bbox_preds=torch.stack(inter_coords),   # cxcywh normalised
            all_dyn_params=torch.stack(inter_dyn),
            enc_cls_scores=enc_cls,
            enc_bbox_preds=enc_coord_unact.sigmoid(),
            topk_idx=topk_idx,
            memory=memory,
            mask_feat=mask_feat,
            mask_pad=mask[:, :n0],
            token_refs=token_refs,
            spatial_shapes=shapes,
            valid_ratios=valid_ratios,
        )

    def predict_masks(self, outs, dyn_params, centers):
        """Mask logits (B, M, h0, w0) of the instance slots with dynamic
        parameters ``dyn_params`` (B, M, 441) at normalised centres
        ``centers`` (B, M, 2)."""
        h0, w0 = outs["spatial_shapes"][0]
        B, M = dyn_params.shape[:2]
        pos = rel_sine_positional_encoding(
            outs["mask_pad"].reshape(B, h0, w0), centers,
            num_feats=self.mask_channels // 2)
        logits = dynamic_mask_attention(
            dyn_params, outs["mask_feat"],
            pos.view(B, M, h0 * w0, self.mask_channels), outs["token_refs"],
            (h0, w0), outs["mask_pad"], self.impl)
        return logits.view(B, M, h0, w0)

    # ------------------------------------------------------------ training
    @staticmethod
    def _factor(img_shape):
        """(B, 2) (h, w) -> (B, 1, 4) (w, h, w, h) float32."""
        h, w = img_shape[:, 0].float(), img_shape[:, 1].float()
        return torch.stack([w, h, w, h], -1)[:, None]

    def _match_cost(self, cls_logits, bbox_pred, batch, binary=False):
        """(B, Q, G) box matching cost: focal class cost, xywh L1 and
        -GIoU, non-finite entries 1e4."""
        B, Q = cls_logits.shape[:2]
        gt = batch["gt_boxes"]
        G = gt.shape[1]
        factor = self._factor(batch["img_shape"])          # (B, 1, 4)
        labels = (torch.zeros_like(batch["gt_labels"]) if binary
                  else batch["gt_labels"]).long()
        logits = torch.gather(cls_logits, 2,
                              labels[:, None, :].expand(B, Q, G))
        p = logits.sigmoid()
        neg = -torch.log(1 - p + 1e-12) * 0.75 * p ** 2
        pos = -torch.log(p + 1e-12) * 0.25 * (1 - p) ** 2
        w = self.cost_weights
        cost = (pos - neg) * w["cls"]
        gt_xywh = xyxy_to_cxcywh(gt / factor)               # (B, G, 4)
        cost = cost + (bbox_pred[:, :, None] - gt_xywh[:, None]).abs().sum(
            -1) * w["reg"]
        cost = cost - giou(cxcywh_to_xyxy(bbox_pred)[:, :, None]
                           * factor[:, :, None], gt[:, None]) * w["iou"]
        return torch.where(torch.isfinite(cost), cost,
                           torch.full_like(cost, 1e4))

    def match(self, outs, batch):
        """Matched query per GT slot (B, G), -1 where invalid, for each
        decoder layer in order and then the encoder proposals (binary
        labels, on their boxes' xyxy round trip); the costs cross to the
        host once."""
        sets = [(outs["all_cls_scores"][d], outs["all_bbox_preds"][d], False)
                for d in range(outs["all_cls_scores"].shape[0])]
        sets.append((outs["enc_cls_scores"],
                     xyxy_to_cxcywh(cxcywh_to_xyxy(outs["enc_bbox_preds"])),
                     True))
        with torch.no_grad():
            costs = [self._match_cost(c, b, batch, binary)
                     for c, b, binary in sets]
        return hungarian_assign(costs, batch["gt_valid"])

    def _box_losses(self, prefix, cls_s, box_p, q_idx, batch, binary=False):
        """Focal, L1 (cxcywh) and GIoU losses of one prediction set; the
        labels scatter onto Q+1 columns, invalid slots into the last,
        which is dropped."""
        B, Q = cls_s.shape[:2]
        valid = batch["gt_valid"]
        num_pos = global_sum(valid.sum().float()).clamp(min=1.0)
        gt_lab = (torch.zeros_like(batch["gt_labels"]) if binary
                  else batch["gt_labels"]).long()
        labels = torch.full((B, Q + 1), self.num_classes, dtype=torch.int64,
                            device=cls_s.device)
        labels.scatter_(1, torch.where(valid, q_idx, Q), gt_lab)
        w = self.loss_weights
        loss_cls = sigmoid_focal_loss(
            cls_s.reshape(-1, self.num_classes), labels[:, :Q].reshape(-1),
            avg_factor=num_pos) * w["cls"]
        idx = q_idx.clamp(min=0)
        pred = torch.gather(box_p, 1, idx[..., None].expand(*idx.shape, 4))
        factor = self._factor(batch["img_shape"])
        gt = batch["gt_boxes"]
        wmask = valid[..., None].to(pred.dtype)
        loss_bbox = ((pred - xyxy_to_cxcywh(gt / factor)).abs()
                     * wmask).sum() / num_pos * w["bbox"]
        g = giou(cxcywh_to_xyxy(pred) * factor, gt)
        loss_iou = ((1 - g) * valid).sum() / num_pos * w["iou"]
        return {f"{prefix}loss_cls": loss_cls,
                f"{prefix}loss_bbox": loss_bbox,
                f"{prefix}loss_iou": loss_iou}

    def forward_train(self, batch, topk_idx=None):
        """Loss dict of one batch, as the JAX ``forward_train``: per decoder
        layer (prefix ``d{i}.``, the last unprefixed) the focal, L1 and
        GIoU losses; the encoder proposals' with binary labels (``enc_``);
        the dice and BCE mask losses on the last layer's matches, the GT
        masks resized to the ×4 mask grid (bilinear, antialiased, as
        ``jax.image.resize``); and their sum ``loss``. Trainable BatchNorm
        runs in train mode; ``topk_idx`` is the proposals' hook."""
        text_feats = batch.get("text_feats")
        if (self.cls_emb_dim and text_feats is not None
                and text_feats.shape[0] != self.num_classes):
            raise ValueError(f"training takes one text embedding per class: "
                             f"{text_feats.shape[0]} for {self.num_classes}")
        outs = self.forward_outputs(batch["img"], batch["img_shape"],
                                    train=True, text_feats=text_feats,
                                    topk_idx=topk_idx)
        *dec_q, enc_q = self.match(outs, batch)
        losses = {}
        D = len(dec_q)
        for d, q_idx in enumerate(dec_q):
            prefix = "" if d == D - 1 else f"d{d}."
            losses.update(self._box_losses(
                prefix, outs["all_cls_scores"][d], outs["all_bbox_preds"][d],
                q_idx, batch))
        losses.update(self._box_losses(
            "enc_", outs["enc_cls_scores"], outs["enc_bbox_preds"], enc_q,
            batch, binary=True))

        # mask losses on the last layer's matched slots
        idx = dec_q[-1].clamp(min=0)
        B, G = idx.shape

        def take(a):
            return torch.gather(a, 1, idx[..., None].expand(B, G,
                                                            a.shape[-1]))

        dyn = take(outs["all_dyn_params"][-1])
        centers = take(outs["all_bbox_preds"][-1])[..., :2].detach()
        preds = aligned_bilinear(self.predict_masks(outs, dyn, centers),
                                 4).sigmoid()
        th, tw = preds.shape[-2:]
        gt_masks = F.interpolate(batch["gt_masks"].float(), size=(th, tw),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)
        valid = batch["gt_valid"].to(preds.dtype)
        num_pos = global_sum(valid.sum()).clamp(min=1.0)
        inter = (preds * gt_masks).sum((-1, -2))
        denom = (preds ** 2).sum((-1, -2)) + (gt_masks ** 2).sum((-1, -2))
        dice = 1 - 2 * inter / denom.clamp(min=1e-6)
        w = self.loss_weights
        losses["loss_mask_dice"] = (dice * valid).sum() / num_pos * w["dice"]
        bce = -(gt_masks * torch.log(preds.clamp(min=1e-6))
                + (1 - gt_masks) * torch.log((1 - preds).clamp(min=1e-6)))
        losses["loss_mask_bce"] = ((bce.mean((-1, -2)) * valid).sum()
                                   / num_pos * w["bce"])
        losses["loss"] = sum(losses.values())
        return losses

    # ---------------------------------------------------------------- test
    def select_detections(self, outs):
        """The ``max_per_img`` best (query, class) pairs of the last
        decoder layer: scores (B, M) and flat indices (B, M) into Q x C',
        C' the logits' own class count."""
        cls = outs["all_cls_scores"][-1].sigmoid()
        return cls.flatten(1).topk(self.max_per_img, dim=1)

    @torch.no_grad()
    def forward_test(self, batch, topk_idx=None, det_idx=None):
        """Detections per image, in the original image's pixels:
        det_bboxes (B, M, 5) xyxy + score, det_labels (B, M), det_masks
        (B, M, 4*h0, 4*w0) probabilities over the padded input at half its
        resolution. The flat top-k over queries x classes decodes with the
        logits' own class count C' (one per row of ``text_feats`` for
        DK-DETR), so every label is below C'. ``topk_idx`` and ``det_idx``
        (B, M) flat indices into Q x C') replace the two selections (a
        check's hooks)."""
        outs = self.forward_outputs(batch["img"], batch["img_shape"],
                                    text_feats=batch.get("text_feats"),
                                    topk_idx=topk_idx)
        cls = outs["all_cls_scores"][-1]
        num_cls = cls.shape[-1]
        if det_idx is None:
            scores, det_idx = self.select_detections(outs)
        else:
            scores = torch.gather(cls.sigmoid().flatten(1), 1, det_idx)
        q_idx = torch.div(det_idx, num_cls, rounding_mode="floor")
        labels = det_idx % num_cls
        B, M = q_idx.shape

        def take(a):
            return torch.gather(a, 1, q_idx[..., None].expand(B, M,
                                                              a.shape[-1]))

        boxes = take(outs["all_bbox_preds"][-1])
        dyn = take(outs["all_dyn_params"][-1])
        masks = aligned_bilinear(self.predict_masks(outs, dyn,
                                                    boxes[..., :2]),
                                 4).sigmoid()
        det = cxcywh_to_xyxy(boxes) * self._factor(batch["img_shape"])
        if "scale_factor" in batch:
            sf = batch["scale_factor"]
            det = det / torch.cat([sf, sf], -1)[:, None]
        return dict(det_bboxes=torch.cat([det, scores[..., None].to(
                        det.dtype)], -1),
                    det_labels=labels, det_masks=masks)
