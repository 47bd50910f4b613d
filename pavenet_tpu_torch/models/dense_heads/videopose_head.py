"""PAVE-Net video pose head (as ``pavenet_tpu/models/dense_heads/
videopose_head.py``): deformable or windowed encoder, two-stage top-k
proposals, per-frame pose decoder, the joint (refine) decoder and the three
RealNVP flows of the RLE losses. With ``num_frames=1`` and PETR's options it
is the PETR head:

- ``with_heatmap``: a one-layer, one-level encoder over the current frame's
  level-0 memory and ``fc_hm``, run only where ``forward`` is asked for the
  heatmap (the train step); it runs without position embedding, as the
  reference's does;
- ``query_from_encoder_token`` False: the decoder's queries are the content
  half of ``query_embedding`` alone (the top-k still picks the reference
  points);
- ``detach_decoder_refs``: each pose and joint decoder layer takes the
  previous layer's reference points detached; the layer outputs keep
  theirs;
- ``rle_flows`` False (L1 keypoint losses): no RealNVP flows.

Batch-first with an explicit frame axis ``(B, T, ...)``. Every layer
computes in ``dtype`` (``layers/dtype.py``); the embeddings stay float32
and promote what they are added to, as in the JAX head.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..attention.deformable import (
    MultiScaleDeformableAttention,
    MultiFrameDeformableAttention,
    MultiFramePoseDeformableAttention,
)
from ..flows.realnvp import RealNVP
from ..layers.dtype import LayerNorm, Linear
from ..layers.positional_encoding import sine_positional_encoding
from ..layers.transformer import FFN, MLP, MultiheadAttention
from ..layers.windowed import WindowedEncoderLayer

Shapes = Tuple[Tuple[int, int], ...]


def inverse_sigmoid(x, eps: float = 1e-5):
    """mmdet ``inverse_sigmoid``: clamped logit."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def bias_init_with_prob(prior_prob: float) -> float:
    return float(-math.log((1 - prior_prob) / prior_prob))


class SigmaBranch(nn.Module):
    """``num_fcs`` affine layers without activation, then a small-gain
    output layer."""

    def __init__(self, embed_dims: int, out_dim: int, num_fcs: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_fcs = num_fcs
        for i in range(num_fcs):
            self.add_module(f"Dense_{i}", Linear(embed_dims, embed_dims,
                                                 dtype=dtype))
        self.add_module(f"Dense_{num_fcs}", Linear(embed_dims, out_dim,
                                                   dtype=dtype))

    def init_fixed_(self, generator):
        w = getattr(self, f"Dense_{self.num_fcs}").weight
        nn.init.xavier_uniform_(w, gain=0.01, generator=generator)

    def forward(self, x):
        for i in range(self.num_fcs + 1):
            x = getattr(self, f"Dense_{i}")(x)
        return x


class EncoderLayer(nn.Module):
    """Deformable self-attention encoder layer, post-norm."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=1024, dropout=0.1,
                 impl="auto", dtype=torch.float32):
        super().__init__()
        self.attn = MultiScaleDeformableAttention(
            embed_dims, num_heads, num_levels, num_points, dropout=dropout,
            impl=impl, dtype=dtype)
        self.norm1 = LayerNorm(embed_dims, dtype=dtype)
        self.ffn = FFN(embed_dims, feedforward_channels, dropout, dtype)
        self.norm2 = LayerNorm(embed_dims, dtype=dtype)

    def forward(self, x, pos, reference_points, spatial_shapes,
                key_padding_mask):
        x = self.attn(x, x, reference_points, spatial_shapes,
                      key_padding_mask=key_padding_mask, query_pos=pos)
        return self.norm2(self.ffn(self.norm1(x)))


class VideoPoseHead(nn.Module):

    def __init__(self, num_classes: int = 1, num_frames: int = 3,
                 num_keypoints: int = 15, num_query: int = 300,
                 embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 3, num_refine_layers: int = 2,
                 encoder_num_points: int = 4, refine_num_points: int = 4,
                 feedforward_channels: int = 1024, num_kpt_fcs: int = 2,
                 dropout: float = 0.1, with_heatmap: bool = False,
                 query_from_encoder_token: bool = True,
                 detach_decoder_refs: bool = False, rle_flows: bool = True,
                 encoder_mode: str = "deformable",
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder_mode not in ("deformable", "windowed"):
            raise ValueError(f"unknown encoder_mode {encoder_mode!r}")
        C, K, T = embed_dims, num_keypoints, num_frames
        self.num_frames, self.num_keypoints = T, K
        self.num_query, self.embed_dims = num_query, C
        self.num_levels = num_levels
        self.num_decoder_layers = num_decoder_layers
        self.num_refine_layers = num_refine_layers
        self.with_heatmap = with_heatmap
        self.query_from_encoder_token = query_from_encoder_token
        self.detach_decoder_refs = detach_decoder_refs
        num_pred = num_decoder_layers + 1   # + encoder proposal head

        add = self.add_module
        d = dtype

        def norm():
            return LayerNorm(C, dtype=d)

        for i in range(num_encoder_layers):
            if encoder_mode == "windowed":   # odd layers shift the windows
                add(f"encoder_layer{i}", WindowedEncoderLayer(
                    C, num_heads, feedforward_channels, dropout,
                    shift=bool(i % 2), impl=impl, dtype=d))
            else:
                add(f"encoder_layer{i}", EncoderLayer(
                    C, num_heads, num_levels, encoder_num_points,
                    feedforward_channels, dropout, impl, d))
        self.num_encoder_layers = num_encoder_layers
        self.level_embeds = nn.Parameter(torch.empty(num_levels, C))
        self.enc_output = Linear(C, C, dtype=d)
        self.enc_output_norm = norm()
        self.query_embedding = nn.Parameter(torch.empty(num_query, 2 * C))
        self.refine_query_embedding = nn.Parameter(torch.empty(K, 2 * C))

        for i in range(num_decoder_layers):
            add(f"dec_self_attn{i}", MultiheadAttention(C, num_heads, dropout,
                                                        d))
            add(f"dec_cross_attn{i}", MultiFramePoseDeformableAttention(
                T, C, num_heads, num_levels, K, dropout=dropout, impl=impl,
                dtype=d))
            for j in (1, 2, 3):
                add(f"dec_norm{j}_{i}", norm())
            add(f"dec_ffn{i}", FFN(C, feedforward_channels, dropout, d))
        kpt_hidden = (512,) * (num_kpt_fcs + 1)
        for i in range(num_pred):
            add(f"cls_branch{i}", Linear(C, num_classes, dtype=d))
            add(f"kpt_branch{i}", MLP(C, kpt_hidden, 2 * K,
                                      zero_init_last=True, dtype=d))
            add(f"sigma_branch{i}", SigmaBranch(C, 2 * K, num_kpt_fcs, d))
        # aux-frame offset branches, frame order (pre..., next...)
        for f in range(T - 1):
            for i in range(num_decoder_layers):
                add(f"aux_kpt_branch_f{f}_l{i}", MLP(C, kpt_hidden, 2 * K,
                                                     dtype=d))

        for i in range(num_refine_layers):
            add(f"ref_self_attn{i}", MultiheadAttention(C, num_heads, dropout,
                                                        d))
            add(f"ref_cross_attn{i}", MultiFrameDeformableAttention(
                T, C, num_heads, num_levels, refine_num_points,
                dropout=dropout, impl=impl, dtype=d))
            for j in (1, 2, 3):
                add(f"ref_norm{j}_{i}", norm())
            add(f"ref_ffn{i}", FFN(C, feedforward_channels, dropout, d))
            add(f"refine_sigma_branch{i}", SigmaBranch(C, 2, num_kpt_fcs, d))
            for f in range(T):
                add(f"refine_kpt_branch_f{f}_l{i}", MLP(
                    C, (C,) * num_kpt_fcs, 2, zero_init_last=True, dtype=d))
        if with_heatmap:     # PETR's heatmap branch (train step only)
            self.fc_hm = Linear(C, K, dtype=d)
            self.hm_encoder_layer = EncoderLayer(
                C, num_heads, 1, encoder_num_points, feedforward_channels,
                dropout, impl, d)
        # RLE flows: encoder proposals, pose decoder, joint decoder (none
        # for L1 keypoint losses, as the JAX tree has none)
        self.enc_flow, self.dec_flow, self.flow = (
            (RealNVP(dtype=d), RealNVP(dtype=d), RealNVP(dtype=d))
            if rle_flows else (None, None, None))

    def init_fixed_(self, generator):
        for p in (self.level_embeds, self.query_embedding,
                  self.refine_query_embedding):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
        for i in range(self.num_decoder_layers + 1):
            nn.init.constant_(getattr(self, f"cls_branch{i}").bias,
                              bias_init_with_prob(0.01))
        if self.with_heatmap:
            nn.init.constant_(self.fc_hm.bias, bias_init_with_prob(0.1))

    def _m(self, name, *idx):
        return getattr(self, name.format(*idx))

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------
    @staticmethod
    def encoder_reference_points(spatial_shapes: Shapes, valid_ratios):
        """(B, N, L, 2) normalised per-token reference grid."""
        B = valid_ratios.shape[0]
        dev = valid_ratios.device
        refs = []
        for lvl, (H, W) in enumerate(spatial_shapes):
            ry = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
            rx = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
            ry = ry[None, :, None] / (valid_ratios[:, lvl, 1][:, None, None] * H)
            rx = rx[None, None, :] / (valid_ratios[:, lvl, 0][:, None, None] * W)
            refs.append(torch.stack([rx.expand(B, H, W), ry.expand(B, H, W)],
                                    -1).reshape(B, H * W, 2))
        ref = torch.cat(refs, 1)
        return ref[:, :, None, :] * valid_ratios[:, None, :, :]

    @staticmethod
    def gen_proposals(spatial_shapes: Shapes, valid_hw, mask_flatten):
        """Logit grid-centre proposals; invalid entries -> 1e6."""
        B = valid_hw.shape[0]
        dev = valid_hw.device
        props = []
        for lvl, (H, W) in enumerate(spatial_shapes):
            gy = torch.arange(H, dtype=torch.float32, device=dev)
            gx = torch.arange(W, dtype=torch.float32, device=dev)
            px = (gx[None, None, :] + 0.5).expand(B, H, W) / valid_hw[
                :, lvl, 0][:, None, None]
            py = (gy[None, :, None] + 0.5).expand(B, H, W) / valid_hw[
                :, lvl, 1][:, None, None]
            props.append(torch.stack([px, py], -1).reshape(B, H * W, 2))
        proposals = torch.cat(props, 1)                      # (B, N, 2)
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
        valid = valid & ~mask_flatten
        logit = torch.log(proposals / (1 - proposals).clamp(min=1e-9))
        logit = torch.where(valid[..., None], logit, torch.full_like(logit, 1e6))
        return logit, valid

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward_encoder(self, mlvl_feats: Sequence[torch.Tensor],
                        mlvl_masks: Sequence[torch.Tensor], valid_ratios):
        """The encoder alone: ``memory`` (B, T, N, C), ``mask_flatten``
        (B, N) (True = pad) and ``spatial_shapes``.

        mlvl_feats: list of (B, T, H_l, W_l, C); mlvl_masks: list of
        (B, H_l, W_l) bool, True = pad; valid_ratios (B, L, 2) xy.
        """
        B, T = mlvl_feats[0].shape[:2]
        C = self.embed_dims
        spatial_shapes: Shapes = tuple(
            (int(f.shape[2]), int(f.shape[3])) for f in mlvl_feats)

        feat_flat, mask_flat, pos_flat = [], [], []
        for lvl, (feat, mask) in enumerate(zip(mlvl_feats, mlvl_masks)):
            H, W = spatial_shapes[lvl]
            feat_flat.append(feat.reshape(B, T, H * W, C))
            mask_flat.append(mask.reshape(B, H * W))
            pos = sine_positional_encoding(mask, num_feats=C // 2).to(
                feat.dtype)
            pos_flat.append(pos.reshape(B, H * W, C)
                            + self.level_embeds[lvl][None, None])
        feat = torch.cat(feat_flat, 2)          # (B, T, N, C)
        mask = torch.cat(mask_flat, 1)          # (B, N)
        pos = torch.cat(pos_flat, 1)            # (B, N, C)
        N = feat.shape[2]

        # --- encoder over all frames (frame folded into batch) ---
        enc_ref = self.encoder_reference_points(spatial_shapes, valid_ratios)
        x = feat.reshape(B * T, N, C)
        pos_bt = pos[:, None].expand(B, T, N, C).reshape(B * T, N, C)
        mask_bt = mask[:, None].expand(B, T, N).reshape(B * T, N)
        ref_bt = enc_ref[:, None].expand(B, T, N, self.num_levels, 2).reshape(
            B * T, N, self.num_levels, 2)
        for i in range(self.num_encoder_layers):
            x = self._m("encoder_layer{}", i)(x, pos_bt, ref_bt,
                                               spatial_shapes, mask_bt)
        return dict(memory=x.view(B, T, N, C), mask_flatten=mask,
                    spatial_shapes=spatial_shapes)

    def forward_heatmap(self, now_memory, mask, valid_ratios,
                        spatial_shapes: Shapes):
        """PETR's heatmap branch: ``hm_pred`` (B, h0, w0, K) logits of the
        current frame's level 0, from one encoder layer over that level
        alone, with a zero position embedding (the reference passes its
        embedding under a misspelt keyword, so it never arrives)."""
        B, _, C = now_memory.shape
        h0, w0 = spatial_shapes[0]
        n0 = h0 * w0
        ref = self.encoder_reference_points(spatial_shapes, valid_ratios)
        x = now_memory[:, :n0]
        hm = self.hm_encoder_layer(
            x, torch.zeros((B, n0, C), dtype=torch.float32, device=x.device),
            ref[:, :n0, :1].contiguous(), (spatial_shapes[0],), mask[:, :n0])
        return self.fc_hm(hm).view(B, h0, w0, self.num_keypoints)

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                mlvl_masks: Sequence[torch.Tensor], valid_ratios,
                topk_idx=None, return_heatmap: bool = False):
        """Encoder -> two-stage proposals -> pose decoder (arguments as
        ``forward_encoder``). ``topk_idx`` (B, num_query), if given,
        replaces the top-k selection of the proposals (a check's hook: two
        runs whose proposal scores nearly tie can then be compared past
        the selection); the selection made is returned as ``topk_idx``.
        ``return_heatmap`` (with ``with_heatmap``) adds ``hm_pred`` and
        its level-0 padding mask ``hm_mask``."""
        enc = self.forward_encoder(mlvl_feats, mlvl_masks, valid_ratios)
        memory, mask = enc["memory"], enc["mask_flatten"]
        spatial_shapes: Shapes = enc["spatial_shapes"]
        B, T, N, C = memory.shape
        K, NQ = self.num_keypoints, self.num_query
        now = T // 2
        now_memory = memory[:, now]
        hm_outs = {}
        if self.with_heatmap and return_heatmap:
            hm_outs = dict(hm_pred=self.forward_heatmap(
                now_memory, mask, valid_ratios, spatial_shapes),
                hm_mask=mlvl_masks[0])

        # --- two-stage proposals from the current frame ---
        level_wh = torch.tensor([[[w, h] for h, w in spatial_shapes]],
                                dtype=torch.float32, device=mask.device)
        proposals_logit, prop_valid = self.gen_proposals(
            spatial_shapes, valid_ratios * level_wh, mask)
        out_mem = now_memory.masked_fill(~prop_valid[..., None], 0.0)
        out_mem = self.enc_output_norm(self.enc_output(out_mem))

        last = self.num_decoder_layers
        enc_cls = self._m("cls_branch{}", last)(out_mem)          # (B,N,1)
        enc_kpt_unact = (self._m("kpt_branch{}", last)(out_mem).view(
            B, N, K, 2) + proposals_logit[:, :, None, :]).view(B, N, 2 * K)
        enc_sigma = self._m("sigma_branch{}", last)(out_mem)      # (B,N,2K)

        # top-k proposals; invalid positions pushed out of the running
        if topk_idx is None:
            topk_scores = torch.where(prop_valid, enc_cls[..., 0],
                                      torch.full_like(enc_cls[..., 0], -1e4))
            topk_idx = topk_scores.topk(NQ, dim=1).indices        # (B, NQ)

        def gather(a):
            return torch.gather(
                a, 1, topk_idx[..., None].expand(B, NQ, a.shape[-1]))

        # the decoder starts from detached proposals (JAX stop_gradient)
        topk_kpts_unact = gather(enc_kpt_unact).detach()
        tgt = gather(out_mem).detach()

        # --- pose decoder ---
        query_pos, query_content = self.query_embedding.split(C, -1)
        query = (tgt + query_content[None] if self.query_from_encoder_token
                 else query_content[None].expand(B, NQ, C))
        query_pos = query_pos[None].expand(B, NQ, C)
        ref = topk_kpts_unact.sigmoid()[:, None].expand(B, T, NQ, 2 * K)
        init_reference = ref

        vr_k = valid_ratios.repeat(1, 1, K)                       # (B,L,2K)
        mask_t = mask[:, None].expand(B, T, N)
        hs_list, refs_list = [], []
        for lid in range(self.num_decoder_layers):
            query = self._m("dec_self_attn{}", lid)(query, query_pos)
            query = self._m("dec_norm1_{}", lid)(query)
            ref_input = ref[:, :, :, None, :] * vr_k[:, None, None]
            query = self._m("dec_cross_attn{}", lid)(
                query, memory, ref_input, spatial_shapes,
                key_padding_mask=mask_t, query_pos=query_pos)
            query = self._m("dec_norm2_{}", lid)(query)
            query = self._m("dec_ffn{}", lid)(query)
            query = self._m("dec_norm3_{}", lid)(query)

            # per-frame reference refinement
            deltas, aux_i = [], 0
            for t in range(T):
                if t == now:
                    deltas.append(self._m("kpt_branch{}", lid)(query))
                else:
                    deltas.append(self._m("aux_kpt_branch_f{}_l{}", aux_i,
                                          lid)(query))
                    aux_i += 1
            ref = (torch.stack(deltas, 1) + inverse_sigmoid(ref)).sigmoid()
            hs_list.append(query)
            refs_list.append(ref)
            if self.detach_decoder_refs:   # the next layer's input only
                ref = ref.detach()

        L_ = self.num_decoder_layers
        return dict(
            all_cls_scores=torch.stack(
                [self._m("cls_branch{}", l)(hs_list[l]) for l in range(L_)]),
            all_kpt_preds=torch.stack([r[:, now] for r in refs_list]),
            all_sigma_preds=torch.stack(
                [self._m("sigma_branch{}", l)(hs_list[l]).sigmoid()
                 for l in range(L_)]),
            enc_cls_scores=enc_cls,
            enc_kpt_preds=enc_kpt_unact.sigmoid(),
            enc_sigma_preds=enc_sigma.sigmoid(),
            frame_kpt_preds=refs_list[-1],        # (B, T, Q, 2K)
            init_reference=init_reference,
            topk_idx=topk_idx,                    # (B, Q)
            memory=memory,                        # (B, T, N, C)
            mask_flatten=mask,                    # (B, N)
            spatial_shapes=spatial_shapes,
            **hm_outs,
        )

    def forward_refine(self, memory, mask_flatten, valid_ratios, ref_poses,
                       spatial_shapes: Shapes):
        """Joint decoder: K keypoint queries per pose candidate.

        memory (B,T,N,C); mask_flatten (B,N); valid_ratios (B,L,2);
        ref_poses (B,M,T,K*2) normalised candidates per frame.
        Returns (kpts (R,B,M,K,2), scores (R,B,M,K,1), sigmas (R,B,M,K,2)).
        """
        B, T, N, C = memory.shape
        M = ref_poses.shape[1]
        K = self.num_keypoints
        now = T // 2

        qp, qc = self.refine_query_embedding.split(C, -1)        # (K, C)
        query = qc[None, None].expand(B, M, K, C)
        query_pos = qp[None, None].expand(B, M, K, C)
        ref = ref_poses.reshape(B, M, T, K, 2).transpose(1, 2)   # (B,T,M,K,2)
        mask_t = mask_flatten[:, None].expand(B, T, N)

        kpts_out, scores_out, sigmas_out = [], [], []
        for lid in range(self.num_refine_layers):
            q = self._m("ref_self_attn{}", lid)(
                query.reshape(B * M, K, C), query_pos.reshape(B * M, K, C))
            q = self._m("ref_norm1_{}", lid)(q)
            ref_input = (ref.reshape(B, T, M * K, 1, 2)
                         * valid_ratios[:, None, None])         # (B,T,MK,L,2)
            q = self._m("ref_cross_attn{}", lid)(
                q.reshape(B, M * K, C), memory, ref_input, spatial_shapes,
                key_padding_mask=mask_t,
                query_pos=query_pos.reshape(B, M * K, C))
            q = self._m("ref_norm2_{}", lid)(q)
            q = self._m("ref_ffn{}", lid)(q)
            query = self._m("ref_norm3_{}", lid)(q).view(B, M, K, C)

            delta = torch.stack(
                [self._m("refine_kpt_branch_f{}_l{}", t, lid)(query)
                 for t in range(T)], 1)                          # (B,T,M,K,2)
            ref = (delta + inverse_sigmoid(ref)).sigmoid()
            sigma = self._m("refine_sigma_branch{}", lid)(query).sigmoid()
            kpts_out.append(ref[:, now])
            scores_out.append((1.0 - sigma).mean(-1, keepdim=True))
            sigmas_out.append(sigma)
            if self.detach_decoder_refs:
                ref = ref.detach()
        return (torch.stack(kpts_out), torch.stack(scores_out),
                torch.stack(sigmas_out))
