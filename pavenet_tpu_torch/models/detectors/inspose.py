"""InsPose (as ``pavenet_tpu/models/detectors/inspose.py``): single-stage,
instance-aware pose estimation in CondInst's manner.

FCOS-style towers over an FPN (``models/necks/fpn.py``) predict, at every
location of five levels, a person score, 2K keypoint offsets and a
controller of 313 dynamic parameters: the weights of a 10 -> 8 -> 8 -> K
FCN of 1x1 convolutions over an 8-channel map shared by the instances (plus
2 coordinate channels relative to the instance), whose output is the
instance's keypoint heatmaps. The class and controller branches are refined
by star deformable 3x3 convolutions (``DeformConvGN``) that sample at 9 of
the predicted keypoints. A heatmap branch at stride 4 (heatmaps, associative
embedding, short-range offsets) adds training losses only.

The star convolutions sample through msda, dispatched by the value's device
(``ops/ms_deform_attn.py``): the hand-written CUDA kernels on the card. The
JAX module makes one call per kernel tap with one-hot tap weights; here the
9 taps fold onto the query axis of one call (``Q = 9 * h * w``, one point
of weight 1). A one-hot call's tap is ``0 * s + ... + 1 * s_t + ... = s_t``
exactly for finite values, so the fold computes the same numbers, and the
same gradients to the value and the locations (JAX's weights are constants
and take none), in one call per star convolution: 2 per level, 10 per
image, where the one-hot form makes 90.

NCHW inside; the flattened levels follow the JAX module's NHWC row-major
point order (y-major, then x). Over ``torch.distributed`` ranks every
normaliser that JAX takes over the global batch is the ``global_sum`` of
the ranks' (``parallel/dist.py``).

Batch dict (tensors on the model's device):
    img:          (B, H, W, 3) float32, normalised
    img_shape:    (B, 2) int (valid h, w) before padding
    scale_factor: (B, 2) float32 (w_scale, h_scale) test-time rescale
    gt_boxes:     (B, G, 4) xyxy in pixels (train)
    gt_keypoints: (B, G, K, 3) x, y in pixels and visibility (train)
    gt_valid:     (B, G) bool (train)
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..backbones.resnet import ResNet
from ..layers.dtype import Conv2d, GroupNorm, Linear
from ..losses.focal_loss import center_focal_loss, varifocal_loss
from ..losses.oks_loss import OKS_SIGMAS
from ..necks.fpn import FPN
from ...ops.ms_deform_attn import ms_deform_attn
from ...ops.nms import soft_nms_scores
from ...parallel.dist import global_sum
from .videopose import jax_like_init_


def fcn_splits(num_keypoints: int):
    """The controller's parameter layout (the reference ``kpt_fcn_head``,
    10 -> 8 -> 8 -> K): weight and bias sizes of the three layers."""
    return 80, 8, 64, 8, 8 * num_keypoints, num_keypoints


# the star convolution's 9 taps sample at these keypoints of K=17 (nose,
# shoulders, wrists, hips, ankles; the reference ``inspose_head.py:344-347``)
STAR_KPT_IDX_K17 = (0, 5, 6, 9, 10, 11, 12, 15, 16)
# FCOS regress ranges of the five levels, by stride order, and the
# soft-NMS IoU (the config's ``soft_nms``, ``iou_threshold=0.3``)
REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))
NMS_IOU_THR = 0.3


def _kernel_taps(device):
    """The 3x3 kernel's (ky, kx) offsets, row-major, float32 (9,) each."""
    k = torch.arange(-1.0, 2.0, device=device)
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    return ky.reshape(-1), kx.reshape(-1)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of (B, C, h, w), ``align_corners=False``: at x2
    the JAX module's ``jax.image.resize(..., 'linear')`` weights are these
    (at the borders JAX drops the outside tap and renormalises, torch
    clamps the index: both give the edge row)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class ConvGN(nn.Module):
    """mmcv ``ConvModule``: 3x3 convolution without bias, GroupNorm, ReLU
    (the convolution in ``dtype``, GroupNorm's statistics in float32)."""

    def __init__(self, cin: int, features: int, groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(cin, features, 3, padding=1, bias=False,
                             dtype=dtype)
        self.GroupNorm_0 = GroupNorm(groups, features, eps=1e-5, dtype=dtype)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class DeformConvGN(nn.Module):
    """3x3 deformable convolution, GroupNorm and ReLU. The patches are
    sampled by msda (one call, the 9 taps on the query axis) and laid out
    tap-major, channel-minor, so the convolution is one ``Linear(9C, F)``
    (the JAX Dense kernel's transpose)."""

    def __init__(self, cin: int, features: int, impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.impl = impl
        self.kernel = Linear(9 * cin, features, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(32, features, eps=1e-5, dtype=dtype)

    def forward(self, x, offsets):
        """x (B, C, h, w); offsets (B, h, w, 18) in feature cells, (dy, dx)
        per kernel tap (torch DCN's convention)."""
        B, C, h, w = x.shape
        dev = x.device
        ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        base_y, base_x = torch.meshgrid(ys, xs, indexing="ij")
        ky, kx = _kernel_taps(dev)
        off = offsets.reshape(B, h * w, 9, 2)
        # normalised sampling locations of every tap, in the JAX order
        loc_y = (base_y.reshape(-1)[None, :, None] + ky[None, None]
                 + off[..., 0]) / h
        loc_x = (base_x.reshape(-1)[None, :, None] + kx[None, None]
                 + off[..., 1]) / w
        locs = torch.stack([loc_x, loc_y], -1).reshape(B, h * w * 9, 1, 1,
                                                       1, 2)
        value = x.permute(0, 2, 3, 1).reshape(B, h * w, 1, C)
        ones = torch.ones(B, h * w * 9, 1, 1, 1, dtype=torch.float32,
                          device=dev)
        patches = ms_deform_attn(value, ((h, w),), locs, ones,
                                 impl=self.impl).reshape(B, h * w, 9 * C)
        y = self.kernel(patches).transpose(1, 2).reshape(B, -1, h, w)
        return F.relu(self.GroupNorm_0(y))


class InsPoseDetector(nn.Module):
    """InsPose R50 (``configs/inspose/inspose_r50_8x4_3x_coco.py``): FPN
    (start level 1, 5 outputs), cls and controller towers of
    ``stacked_convs`` ``ConvGN`` at ``feat_channels``, a keypoint tower of
    ``stacked_convs_kpt`` at ``feat_channels_kpt``, a shared tower of 4
    ``ConvGN`` at ``shared_channels`` and an 8-channel GN(2) tail, and with
    ``with_hm`` a heatmap tower at ``feat_channels_hm`` whose last
    convolution runs after a bilinear x2. The FCOS regress ranges, the
    soft-NMS IoU (0.3) and the offset loss's weight (1) are the JAX
    module's defaults, which its builder never sets."""

    num_frames = 1
    freeze_backbone_neck = False
    # the ResNet's frozen stem and stage 1 and its frozen BatchNorm: the
    # JAX module's ResNet defaults (read by the optimizer's labels too)
    frozen_stages = 1
    norm_eval = True

    def __init__(self, num_classes: int = 1, num_keypoints: int = 17,
                 backbone_depth: int = 50,
                 feat_channels: int = 256, feat_channels_kpt: int = 512,
                 feat_channels_hm: int = 512, shared_channels: int = 128,
                 stacked_convs: int = 4, stacked_convs_kpt: int = 4,
                 stacked_convs_hm: int = 3, with_hm: bool = True,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 max_per_img: int = 100, score_thr: float = 0.05,
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 loss_cls_weight: float = 1.0,
                 loss_hm_weight: float = 1.0, impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.num_keypoints = num_classes, num_keypoints
        self.max_per_img, self.score_thr = max_per_img, score_thr
        self.strides = tuple(strides)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.loss_weights = dict(cls=loss_cls_weight, hm=loss_hm_weight)
        self.with_hm = with_hm
        self.stacked_convs, self.stacked_convs_kpt = (stacked_convs,
                                                      stacked_convs_kpt)
        self.stacked_convs_hm = stacked_convs_hm
        d, F_, K = dtype, feat_channels, num_keypoints
        self.backbone = ResNet(backbone_depth, (0, 1, 2, 3), self.norm_eval,
                               self.frozen_stages, d)
        self.neck = FPN(self.backbone.out_channels, F_, start_level=1,
                        num_outs=len(self.strides), dtype=d)
        add = self.add_module
        for name, n, width in (("cls_tower", stacked_convs, F_),
                               ("ctrl_tower", stacked_convs, F_),
                               ("kpt_tower", stacked_convs_kpt,
                                feat_channels_kpt),
                               ("shared_tower", 4, shared_channels)):
            for i in range(n):
                add(f"{name}{i}", ConvGN(F_ if i == 0 else width, width,
                                         dtype=d))
        self.shared_out = ConvGN(shared_channels, 8, groups=2, dtype=d)
        self.conv_cls = Conv2d(2 * F_, num_classes, 3, padding=1, dtype=d)
        self.controller = Conv2d(2 * F_, sum(fcn_splits(K)), 3, padding=1,
                                 dtype=d)
        self.kpt_offset = Conv2d(feat_channels_kpt, 2 * K, 3, padding=1,
                                 dtype=d)
        self.cls_star = DeformConvGN(F_, F_, impl=impl, dtype=d)
        self.ctr_star = DeformConvGN(F_, F_, impl=impl, dtype=d)
        if with_hm:
            for i in range(stacked_convs_hm):
                add(f"hm_tower{i}", ConvGN(F_ if i == 0 else feat_channels_hm,
                                           feat_channels_hm, dtype=d))
            self.hm_pred = Conv2d(feat_channels_hm, K, 3, padding=1, dtype=d)
            self.ae_pred = Conv2d(feat_channels_hm, K, 3, padding=1, dtype=d)
            self.hm_offset = Conv2d(feat_channels_hm, 2 * K, 3, padding=1,
                                    dtype=d)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights that follow the JAX initialisers
        (``videopose.jax_like_init_``): the class prior -log(99) and the
        heatmap prior -log(9) in the biases."""
        jax_like_init_(self, generator)

    def init_fixed_(self, generator):
        nn.init.constant_(self.conv_cls.bias, -math.log((1 - 0.01) / 0.01))
        if self.with_hm:
            nn.init.constant_(self.hm_pred.bias, -math.log((1 - 0.1) / 0.1))

    def _tower(self, name, n, x):
        for i in range(n):
            x = getattr(self, f"{name}{i}")(x)
        return x

    # ------------------------------------------------------------ levels
    def star_offsets(self, offset):
        """The star convolution's offsets (B, h, w, 18) from the keypoint
        offsets (B, 2K, h, w): a tenth of the gradient goes through, (dx,
        dy) becomes (dy, dx), the 9 star keypoints are picked and the 3x3
        kernel's base taken off (``DeformConvGN`` adds it back, so a tap
        samples at its location plus the keypoint's offset)."""
        B, _, h, w = offset.shape
        K = self.num_keypoints
        gm = 0.1
        o = offset.detach() * (1 - gm) + offset * gm
        o = o.permute(0, 2, 3, 1).reshape(B, h, w, K, 2).flip(-1)
        sel = STAR_KPT_IDX_K17 if K == 17 else tuple(range(9))
        o = o[:, :, :, list(sel)].reshape(B, h, w, 18)
        ky, kx = _kernel_taps(offset.device)
        return o - torch.stack([ky, kx], -1).reshape(18).to(o.dtype)

    def forward_levels(self, img, with_hm: bool = True):
        """Per level: ``cls`` (B, C, h, w), ``dyn`` (B, 313, h, w),
        ``offset`` (B, 2K, h, w) and ``shape``; the shared 8-channel map
        (B, 8, h0, w0) of level 0; with ``with_hm`` (and the model's) the
        heatmap branch's ``hm``, ``ae`` (B, K, 2h0, 2w0) and ``offset``
        (B, 2K, 2h0, 2w0), else None."""
        feats = self.neck(self.backbone(img.permute(0, 3, 1, 2)))
        outs, shared, hm_feats = [], None, None
        for lvl, x in enumerate(feats):
            c = self._tower("cls_tower", self.stacked_convs, x)
            t = self._tower("ctrl_tower", self.stacked_convs, x)
            k = self._tower("kpt_tower", self.stacked_convs_kpt, x)
            offset = self.kpt_offset(k)
            star = self.star_offsets(offset)
            c_star = self.cls_star(c, star)
            t_star = self.ctr_star(t, star)
            outs.append(dict(cls=self.conv_cls(torch.cat([c, c_star], 1)),
                             dyn=self.controller(torch.cat([t, t_star], 1)),
                             offset=offset, shape=tuple(x.shape[-2:])))
            if lvl == 0:
                shared = self.shared_out(self._tower("shared_tower", 4, x))
                if with_hm and self.with_hm:
                    n = self.stacked_convs_hm
                    hs = self._tower("hm_tower", n - 1, x)
                    hs = getattr(self, f"hm_tower{n - 1}")(
                        upsample2x_bilinear(hs))
                    hm_feats = dict(hm=self.hm_pred(hs), ae=self.ae_pred(hs),
                                    offset=self.hm_offset(hs))
        return outs, shared, hm_feats

    @staticmethod
    def level_points(shape, stride, device=None):
        """Cell centres (h*w, 2) xy in pixels, row-major."""
        h, w = shape
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) \
            * stride
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) \
            * stride
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([xx, yy], -1).reshape(-1, 2)

    def flatten_levels(self, outs):
        """The levels' ``cls`` (B, N, C), ``dyn`` (B, N, 313), ``offset``
        (B, N, 2K), points (N, 2) and strides (N,), level after level."""
        cls, dyn, off, pts, strides = [], [], [], [], []
        for lvl, o in enumerate(outs):
            dev = o["cls"].device
            for acc, key in ((cls, "cls"), (dyn, "dyn"), (off, "offset")):
                acc.append(o[key].flatten(2).transpose(1, 2))
            pts.append(self.level_points(o["shape"], self.strides[lvl], dev))
            strides.append(torch.full((pts[-1].shape[0],),
                                      float(self.strides[lvl]),
                                      dtype=torch.float32, device=dev))
        return (torch.cat(cls, 1), torch.cat(dyn, 1), torch.cat(off, 1),
                torch.cat(pts, 0), torch.cat(strides, 0))

    def dynamic_heatmaps(self, dyn_params, shared, centers, normalize=None,
                         stride: int = 8):
        """Keypoint heatmap logits (B, M, h0*w0, K) of M instances: each
        instance's 313 parameters ``dyn_params`` (B, M, 313) are its FCN,
        run over the shared map (B, 8, h0, w0) and the coordinates of every
        cell relative to its centre ``centers`` (B, M, 2) xy in pixels,
        over ``normalize`` (B, M) (64 where None: training; the reference
        ``get_coord_map`` takes ``2**lvl * 64``). Batched matmuls over
        (B, M); computed in the promotion of the map's and the parameters'
        dtypes with float32, as JAX's concatenation with the float32
        coordinates promotes."""
        B, M, _ = dyn_params.shape
        h0, w0 = shared.shape[-2:]
        K = self.num_keypoints
        o = np.cumsum((0,) + fcn_splits(K)).tolist()
        dev = shared.device
        ys = torch.arange(h0, dtype=torch.float32, device=dev) * stride \
            + stride // 2
        xs = torch.arange(w0, dtype=torch.float32, device=dev) * stride \
            + stride // 2
        if normalize is None:
            normalize = torch.full(centers.shape[:2], 64.0,
                                   dtype=torch.float32, device=dev)
        cm_x = (xs[None, None, :] - centers[..., 0, None]) \
            / normalize[..., None]                           # (B, M, w0)
        cm_y = (ys[None, None, :] - centers[..., 1, None]) \
            / normalize[..., None]                           # (B, M, h0)
        cm = torch.stack([cm_x[:, :, None, :].expand(B, M, h0, w0),
                          cm_y[:, :, :, None].expand(B, M, h0, w0)], -1)
        dt = torch.promote_types(torch.promote_types(shared.dtype, cm.dtype),
                                 dyn_params.dtype)
        feat = shared.flatten(2).transpose(1, 2).to(dt)       # (B, n0, 8)
        x = torch.cat([feat[:, None].expand(B, M, h0 * w0, 8),
                       cm.reshape(B, M, h0 * w0, 2).to(dt)], -1)
        p = dyn_params.to(dt)

        def layer(x, i, cout, cin):
            wgt = p[..., o[i]:o[i + 1]].reshape(B, M, cout, cin)
            return x @ wgt.transpose(-1, -2) + p[..., None, o[i + 1]:o[i + 2]]

        x = F.relu(layer(x, 0, 8, 10))
        x = F.relu(layer(x, 2, 8, 8))
        return layer(x, 4, K, 8)

    # ------------------------------------------------------------ training
    def assign(self, points, strides_flat, gt_boxes, gt_valid):
        """Vectorised FCOS assignment of every point (N,) to a GT of each
        image, ``gt_boxes`` (B, G, 4) and ``gt_valid`` (B, G): inside the
        GT's centre box of ``center_sample_radius`` strides (clipped to the
        GT) or, without centre sampling, inside the GT; its largest side
        distance within the level's regress range; the smallest such GT
        wins (the first on a tie). Returns the GT index (B, N), -1 where
        none, and the positive mask (B, N)."""
        x = points[None, :, None, 0]
        y = points[None, :, None, 1]
        bx0, by0, bx1, by1 = (gt_boxes[:, None, :, i] for i in range(4))
        ltrb = torch.stack([x - bx0, y - by0, bx1 - x, by1 - y], -1)
        if self.center_sampling:
            rad = strides_flat[None, :, None] * self.center_sample_radius
            cx = (bx0 + bx1) / 2
            cy = (by0 + by1) / 2
            x0 = torch.maximum(cx - rad, bx0)
            y0 = torch.maximum(cy - rad, by0)
            x1 = torch.minimum(cx + rad, bx1)
            y1 = torch.minimum(cy + rad, by1)
            cb = torch.stack([x - x0, y - y0, x1 - x, y1 - y], -1)
            inside = cb.amin(-1) > 0
        else:
            inside = ltrb.amin(-1) > 0
        max_reg = ltrb.amax(-1)
        dev = points.device
        ranges = torch.tensor(REGRESS_RANGES, dtype=torch.float32,
                              device=dev)
        sidx = torch.searchsorted(torch.tensor(self.strides,
                                               dtype=torch.float32,
                                               device=dev), strides_flat)
        lo = ranges[sidx, 0][None, :, None]
        hi = ranges[sidx, 1][None, :, None]
        in_range = (max_reg >= lo) & (max_reg <= hi)
        areas = ((gt_boxes[..., 2] - gt_boxes[..., 0])
                 * (gt_boxes[..., 3] - gt_boxes[..., 1]))      # (B, G)
        cand = inside & in_range & gt_valid[:, None, :]
        big = 1e18
        area_mat = torch.where(cand, areas[:, None, :],
                               torch.full_like(areas[:, None, :], big))
        gt_idx = area_mat.argmin(-1)
        pos = area_mat.amin(-1) < big
        return torch.where(pos, gt_idx, torch.full_like(gt_idx, -1)), pos

    def compute_oks(self, pred_cells, gt_cells, gt_areas):
        """The reference ``compute_oks`` on stride-8 cells against the
        full-resolution box area (B, G) (the reference takes the mask's):
        (B, G)."""
        sig = torch.as_tensor(OKS_SIGMAS[self.num_keypoints],
                              device=gt_cells.device)
        var = (sig * 2) ** 2
        valid = gt_cells[..., 2] > 0                          # (B, G, K)
        d2 = ((pred_cells[..., 0] - gt_cells[..., 0]) ** 2
              + (pred_cells[..., 1] - gt_cells[..., 1]) ** 2)
        e = d2 / var / (gt_areas[..., None] + 1e-4) / 2
        sim = torch.where(valid, torch.exp(-e), torch.zeros_like(e))
        return sim.sum(-1) / valid.sum(-1).clamp(min=1)

    def forward_train(self, batch):
        """The loss dict of one batch, as the JAX ``forward_train``:
        ``loss_keypoint`` (softmax cross-entropy of each GT's dynamic
        heatmaps at its keypoints' cells, one controller per GT slot taken
        at its centre's level-0 cell), ``loss_cls`` (varifocal, the
        decoded pose's OKS as the positives' quality, 0.1 for a GT without
        a visible keypoint), ``loss_keypoint_reg`` (stride-normalised L1 of
        the positives' offsets), with ``with_hm`` the heatmap branch's
        ``loss_heatmap``, ``loss_ae_pull``, ``loss_ae_push`` and
        ``loss_heatmap_offset``, and their sum ``loss``."""
        if "gt_boxes" not in batch:
            raise KeyError("InsPose trains on batches with 'gt_boxes', as "
                           "the JAX forward_train reads them")
        img = batch["img"]
        B = img.shape[0]
        K = self.num_keypoints
        s0 = self.strides[0]
        outs, shared, hm_feats = self.forward_levels(img)
        cls_s, dyn_s, off_s, points, strides_flat = self.flatten_levels(outs)
        gt_boxes = batch["gt_boxes"].float()
        gt_kpts = batch["gt_keypoints"].float()                # (B, G, K, 3)
        gt_valid = batch["gt_valid"].bool()
        gt_idx, pos = self.assign(points, strides_flat, gt_boxes, gt_valid)
        losses = {}

        # dynamic instance heatmaps, one controller per GT slot
        G = gt_boxes.shape[1]
        centers = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2   # (B, G, 2)
        h0, w0 = outs[0]["shape"]
        n0 = h0 * w0
        cx = torch.div(centers[..., 0], s0, rounding_mode="floor").long() \
            .clamp(0, w0 - 1)
        cy = torch.div(centers[..., 1], s0, rounding_mode="floor").long() \
            .clamp(0, h0 - 1)
        pt_idx = cy * w0 + cx                                   # (B, G)
        dyn = torch.gather(dyn_s[:, :n0], 1, pt_idx[..., None].expand(
            B, G, dyn_s.shape[-1]))
        hm = self.dynamic_heatmaps(dyn, shared, centers)        # (B,G,n0,K)

        # loss_keypoint: cross-entropy over the h0*w0 cells at the GT
        # keypoint's cell
        gt_cells = torch.cat([torch.floor(gt_kpts[..., :2] / s0),
                              gt_kpts[..., 2:]], -1)
        cell_x = gt_cells[..., 0].long().clamp(0, w0 - 1)
        cell_y = gt_cells[..., 1].long().clamp(0, h0 - 1)
        tgt_cell = cell_y * w0 + cell_x                         # (B, G, K)
        logp = torch.log_softmax(hm, dim=2)
        picked = torch.gather(logp, 2, tgt_cell[:, :, None]).squeeze(2)
        kvalid = ((gt_kpts[..., 2] > 0) & gt_valid[..., None]).float()
        n_kp = global_sum(kvalid.sum())
        losses["loss_keypoint"] = -(picked * kvalid).sum() / n_kp.clamp(
            min=1.0)

        # loss_cls: varifocal, the decoded pose's OKS at the positives
        with torch.no_grad():
            am = hm.argmax(2)                                   # (B, G, K)
            pred_cells = torch.stack([(am % w0).float(),
                                      torch.div(am, w0,
                                                rounding_mode="floor")
                                      .float()], -1)
            areas = ((gt_boxes[..., 2] - gt_boxes[..., 0])
                     * (gt_boxes[..., 3] - gt_boxes[..., 1]))
            oks = self.compute_oks(pred_cells, gt_cells, areas)  # (B, G)
            has_valid = (gt_kpts[..., 2] > 0).any(-1)
            gt_weight = torch.where(has_valid, oks,
                                    torch.full_like(oks, 0.1))
            safe = gt_idx.clamp(min=0)
            point_w = torch.gather(gt_weight, 1, safe)
            target_score = torch.where(pos, point_w,
                                       torch.zeros_like(point_w))
            # the positives and the images of the global batch
            avg = global_sum(pos.sum().float() + B)
        losses["loss_cls"] = varifocal_loss(
            cls_s.reshape(-1, self.num_classes), target_score.reshape(-1, 1),
            avg_factor=avg) * self.loss_weights["cls"]

        # loss_keypoint_reg: stride-normalised L1 at the positives
        N = points.shape[0]
        tgt_k = torch.gather(gt_kpts, 1, safe[..., None, None].expand(
            B, N, K, 3))                                        # (B,N,K,3)
        vis = (tgt_k[..., 2] > 0) & pos[..., None]
        tgt_off = (tgt_k[..., :2] - points[None, :, None, :]) \
            / strides_flat[None, :, None, None]
        pred_off = off_s.reshape(B, -1, K, 2)
        nvis = (global_sum(vis.sum().float()) * 2).clamp(min=1.0)
        losses["loss_keypoint_reg"] = ((pred_off - tgt_off).abs()
                                       * vis[..., None]).sum() / nvis

        if self.with_hm:
            losses.update(self.heatmap_ae_offset_losses(
                hm_feats, gt_kpts, gt_boxes, gt_valid))
        losses["loss"] = sum(losses.values())
        return losses

    @staticmethod
    def _gaussian_radius(h, w, min_overlap):
        """The reference's ``gaussian_radius``: CornerNet's formula with
        all three roots divided by 2 (not 2a), kept as it is."""
        b1 = h + w
        c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
        r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2
        b2 = 2 * (h + w)
        c2 = (1 - min_overlap) * w * h
        r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0.0))) / 2
        b3 = -2 * min_overlap * (h + w)
        c3 = (min_overlap - 1) * w * h
        r3 = (b3 + torch.sqrt((b3 ** 2 - 16 * min_overlap * c3).clamp(
            min=0.0))) / 2
        return torch.minimum(torch.minimum(r1, r2), r3)

    def heatmap_ae_offset_losses(self, hm_feats, gt_kpts, gt_boxes, gt_valid,
                                 min_overlap_hm=0.9, max_hm_radius=3.0,
                                 min_overlap_kp=0.9, max_offset_radius=3.0,
                                 ae_weight=1.0):
        """The stride-4 heatmap branch's losses (the reference
        ``heatmap_ae_offset_loss``): CenterFocal on Gaussian-splatted
        keypoint heatmaps, associative-embedding pull and push on the tag
        map at the keypoints' cells, with the reference's ``gt_kp_int - 1``
        indexing (which wraps around at 0), and the L1 of the short-range
        offsets to the nearest keypoint within the radius box. The targets
        (B, G, K, h4, w4) take no gradient and are built without one."""
        hm_p, ae_p, off_p = hm_feats["hm"], hm_feats["ae"], hm_feats["offset"]
        B, K, h4, w4 = hm_p.shape
        dev = hm_p.device
        kvalid = (gt_kpts[..., 2] > 0) & gt_valid[..., None]    # (B, G, K)
        kp4 = gt_kpts[..., :2] / 4.0                            # (B, G, K, 2)
        kp_int = torch.floor(kp4)
        with torch.no_grad():
            bw = (gt_boxes[..., 2] - gt_boxes[..., 0]) / 4.0
            bh = (gt_boxes[..., 3] - gt_boxes[..., 1]) / 4.0
            r_hm = torch.floor(self._gaussian_radius(
                bh, bw, min_overlap_hm)).clamp(0.0, max_hm_radius)  # (B, G)
            r_off = torch.floor(self._gaussian_radius(
                bh, bw, min_overlap_kp)).clamp(0.0, max_offset_radius)
            xs = torch.arange(w4, dtype=torch.float32, device=dev)
            ys = torch.arange(h4, dtype=torch.float32, device=dev)
            dxc = xs - kp_int[..., 0, None]                     # (B,G,K,w4)
            dyc = ys - kp_int[..., 1, None]                     # (B,G,K,h4)
            dx = dxc[:, :, :, None, :]
            dy = dyc[..., None]

            def box(r):
                r = r[..., None, None, None]
                return (dx.abs() <= r) & (dy.abs() <= r)        # (B,G,K,h,w)

            sigma = (2 * r_hm + 1) / 6.0
            g = torch.exp(-(dx ** 2 + dy ** 2)
                          / (2 * sigma[..., None, None, None] ** 2 + 1e-12))
            g = torch.where(box(r_hm) & kvalid[..., None, None], g,
                            torch.zeros_like(g))
            hm_target = g.amax(1)                               # (B,K,h4,w4)
            del g
            # short-range offsets: the exact keypoint minus the cell; the
            # nearest keypoint within its radius box wins
            ox = kp4[..., 0, None] - (kp_int[..., 0, None] + dxc)
            oy = kp4[..., 1, None] - (kp_int[..., 1, None] + dyc)
            d2o = ox[:, :, :, None, :] ** 2 + oy[..., None] ** 2
            d2o = torch.where(box(r_off) & kvalid[..., None, None], d2o,
                              torch.full_like(d2o, float("inf")))
            best = d2o.argmin(1)                                # (B,K,h4,w4)
            anyhit = torch.isfinite(d2o.amin(1))
            shape = d2o.shape
            del d2o
            ox_b = torch.gather(ox[:, :, :, None, :].expand(shape), 1,
                                best[:, None]).squeeze(1)
            oy_b = torch.gather(oy[..., None].expand(shape), 1,
                                best[:, None]).squeeze(1)
            mask = anyhit.float()                               # (B,K,h4,w4)
            tgt = torch.stack([ox_b, oy_b], 2)                  # (B,K,2,h,w)
            tgt = torch.where(mask[:, :, None] > 0, tgt, torch.zeros_like(tgt))
            m2 = mask[:, :, None].expand(B, K, 2, h4, w4)
            m2_sum = global_sum(m2.sum())
        p = torch.sigmoid(hm_p).clamp(1e-4, 1 - 1e-4)
        loss_hm = center_focal_loss(p, hm_target) * self.loss_weights["hm"]
        pred = off_p.reshape(B, K, 2, h4, w4)
        loss_hm_offset = (pred * m2 - tgt * m2).abs().sum() / (m2_sum + 1e-4)

        # associative embedding at the keypoints' cells, indexed at
        # (x - 1, y - 1) with the wrap-around of a negative index
        tx = torch.remainder(kp_int[..., 0].long() - 1, w4)
        ty = torch.remainder(kp_int[..., 1].long() - 1, h4)
        flat_idx = ty * w4 + tx                                 # (B, G, K)
        tags_k = torch.gather(ae_p.reshape(B, K, h4 * w4), 2,
                              flat_idx.transpose(1, 2)).transpose(1, 2)
        kv = kvalid.float()
        nk = kv.sum(-1)                                         # (B, G)
        tag_mean = (tags_k * kv).sum(-1) / nk.clamp(min=1.0)
        inst_ok = nk > 0
        pull_g = ((tags_k - tag_mean[..., None]) ** 2 * kv).sum(-1) \
            / nk.clamp(min=1.0)
        n_tags = inst_ok.sum(-1).float()                        # (B,)
        zero = torch.zeros_like(n_tags)
        pull = torch.where(n_tags > 0, (pull_g * inst_ok).sum(-1)
                           / n_tags.clamp(min=1.0), zero)
        diff = tag_mean[:, :, None] - tag_mean[:, None, :]
        pairm = (inst_ok[:, :, None] & inst_ok[:, None, :]).float()
        push_m = (torch.exp(-diff ** 2) * pairm).sum((-1, -2)) - n_tags
        push = torch.where(n_tags > 1, push_m / (n_tags * (n_tags - 1) * 2)
                           .clamp(min=1.0), zero)
        # the mean over the global batch's images
        images = global_sum(torch.tensor(float(B), device=dev))
        return {"loss_heatmap": loss_hm,
                "loss_ae_pull": ae_weight * pull.sum() / images,
                "loss_ae_push": ae_weight * push.sum() / images,
                "loss_heatmap_offset": loss_hm_offset}

    # ---------------------------------------------------------------- test
    @torch.no_grad()
    def forward_test(self, batch, topk_idx=None):
        """Detections per image: ``det_kpts`` (B, M, K, 3) in the original
        image's pixels with each keypoint's heatmap score, ``det_bboxes``
        (B, M, 5) the keypoints' extent and the soft-NMS score,
        ``det_labels`` (B, M) zeros and ``keep`` (B, M), the soft-NMS
        score above ``score_thr``. The M = ``max_per_img`` best locations
        over all levels; a keypoint is its regressed offset, replaced by
        its dynamic heatmap's argmax cell where that cell's sigmoid is
        above 0.1. ``topk_idx`` (B, M) indices into the flattened levels
        replaces the top-k (a check's hook past a tie)."""
        img = batch["img"]
        B = img.shape[0]
        K, M, s0 = self.num_keypoints, self.max_per_img, self.strides[0]
        outs, shared, _ = self.forward_levels(img, with_hm=False)
        cls_s, dyn_s, off_s, points, strides_flat = self.flatten_levels(outs)
        scores = torch.sigmoid(cls_s)[..., 0]                   # (B, N)
        if topk_idx is None:
            top_scores, idx = scores.topk(M, dim=1)
        else:
            idx = topk_idx
            top_scores = torch.gather(scores, 1, idx)
        M = idx.shape[1]

        def take(a):
            return torch.gather(a, 1, idx[..., None].expand(B, M,
                                                            a.shape[-1]))

        dyn, off = take(dyn_s), take(off_s)
        pts = points[idx]                                       # (B, M, 2)
        strd = strides_flat[idx]
        kpts = pts[:, :, None, :] + off.reshape(B, M, K, 2) \
            * strd[..., None, None]
        # the coordinate maps' scale by level: 2^lvl * 64 = 8 * stride
        norm = strd * (64.0 / s0)
        hm = self.dynamic_heatmaps(dyn, shared, pts, normalize=norm)
        w0 = outs[0]["shape"][1]
        am = hm.argmax(2)                                       # (B, M, K)
        hm_y = torch.div(am, w0, rounding_mode="floor").float() * s0 + s0 / 2
        hm_x = (am % w0).float() * s0 + s0 / 2
        hm_score = torch.sigmoid(hm.amax(2))
        kpts = torch.where(hm_score[..., None] > 0.1,
                           torch.stack([hm_x, hm_y], -1).to(kpts.dtype), kpts)
        if "scale_factor" in batch:
            kpts = kpts / batch["scale_factor"][:, None, None, :]
        det_kpts = torch.cat([kpts, hm_score[..., None].to(kpts.dtype)], -1)
        boxes = torch.stack([kpts[..., 0].amin(-1), kpts[..., 1].amin(-1),
                             kpts[..., 0].amax(-1), kpts[..., 1].amax(-1)],
                            -1)
        decayed = soft_nms_scores(boxes, top_scores, NMS_IOU_THR)
        det_bboxes = torch.cat([boxes, decayed[..., None].to(boxes.dtype)],
                               -1)
        return dict(det_kpts=det_kpts, det_bboxes=det_bboxes,
                    det_labels=torch.zeros_like(idx),
                    keep=decayed > self.score_thr)
