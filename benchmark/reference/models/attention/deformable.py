"""Deformable attention modules (as ``pavenet_tpu/models/attention/
deformable.py``).

- ``MultiScaleDeformableAttention``: single-frame encoder self-attention.
- ``MultiFrameDeformableAttention``: joint-decoder cross-attention over T
  frames.
- ``MultiFramePoseDeformableAttention``: pose-decoder cross-attention with
  P = K keypoint sampling points per query.

The frame axis is folded into the batch for one msda call per layer; the
per-frame offset and weight heads are one fused Linear of width ``T*...``.
Each applies dropout after its output projection, as the JAX modules do.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops.ms_deform_attn import ms_deform_attn
from ..layers.transformer import Dropout


def make_sampling_locations(reference_points, offsets, spatial_shapes):
    """Deformable-DETR's rule: point references ``(..., Q, L, 2)`` plus the
    offsets ``(..., Q, H, L, P, 2)`` in pixels of each level."""
    ref = reference_points[..., :, None, :, None, :]
    normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                              dtype=offsets.dtype, device=offsets.device)
    return ref + offsets / normalizer[None, :, None, :]


def pose_sampling_locations(reference_points, offsets):
    """Pose-aware rule: per-keypoint references plus offsets scaled by the
    keypoints' bounding box. reference_points ``(..., Q, L, K*2)``, offsets
    ``(..., Q, H, L, K, 2)``; returns ``(..., Q, H, L, K, 2)``."""
    *lead, Q, L, K2 = reference_points.shape
    ref = reference_points.reshape(*lead, Q, L, K2 // 2, 2)
    lo = ref.amin(-2, keepdim=True)
    hi = ref.amax(-2, keepdim=True)
    wh = (hi - lo).clamp(min=1e-4)                  # (..., Q, L, 1, 2)
    return ref[..., :, None, :, :, :] + offsets * wh[..., :, None, :, :, :] * 0.5


class MultiScaleDeformableAttention(nn.Module):
    """Single-frame multi-scale deformable attention (encoder self-attn)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        HLP = num_heads * num_levels * num_points
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.sampling_offsets = nn.Linear(embed_dims, HLP * 2)
        self.attention_weights = nn.Linear(embed_dims, HLP)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.drop = Dropout(dropout)

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence, key_padding_mask=None,
                query_pos=None):
        """query (B,Q,C); value (B,N,C); reference_points (B,Q,L,2);
        key_padding_mask (B,N) True = padded."""
        identity = query
        if query_pos is not None:
            query = query + query_pos
        B, Q, _ = query.shape
        N = value.shape[1]
        H, L, P = self.num_heads, self.num_levels, self.num_points
        # project, then zero the padded keys
        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        v = v.view(B, N, H, self.embed_dims // H)
        offsets = self.sampling_offsets(query).view(B, Q, H, L, P, 2)
        weights = self.attention_weights(query).view(B, Q, H, L * P)
        weights = weights.softmax(-1).view(B, Q, H, L, P)
        locations = make_sampling_locations(reference_points, offsets,
                                            spatial_shapes)
        out = ms_deform_attn(v, spatial_shapes, locations, weights)
        return identity + self.drop(self.output_proj(out))


class _MultiFrameBase(nn.Module):
    """Shared machinery of the multi-frame variants."""

    def __init__(self, num_frames: int = 3, embed_dims: int = 256,
                 num_heads: int = 8, num_levels: int = 4, num_points: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        self.num_frames, self.embed_dims = num_frames, embed_dims
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points = num_points
        THLP = num_frames * num_heads * num_levels * num_points
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.sampling_offsets = nn.Linear(embed_dims, THLP * 2)
        self.attention_weights = nn.Linear(embed_dims, THLP)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.drop = Dropout(dropout)

    def _project_value(self, value, key_padding_mask):
        """value (B,T,N,C); mask (B,T,N). Zero the padded keys, then project
        (the bias survives at padded keys)."""
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        v = self.value_proj(value)
        B, T, N, _ = v.shape
        return v.view(B, T, N, self.num_heads,
                      self.embed_dims // self.num_heads)

    def _frame_heads(self, query):
        """Offsets (B,T,Q,H,L,P,2), softmax weights (B,T,Q,H,L,P) and frame
        fusion weights (B,T,Q,H) = exp(raw).sum over L*P, normalised over
        frames."""
        B, Q, _ = query.shape
        T, H, L, P = (self.num_frames, self.num_heads, self.num_levels,
                      self.num_points)
        offsets = self.sampling_offsets(query).view(
            B, Q, T, H, L, P, 2).transpose(1, 2)
        raw_w = self.attention_weights(query).view(
            B, Q, T, H, L * P).transpose(1, 2)
        weights = raw_w.softmax(-1).view(B, T, Q, H, L, P)
        frame_w = raw_w.exp().sum(-1)                    # (B, T, Q, H)
        frame_w = frame_w / frame_w.sum(1, keepdim=True)
        return offsets, weights, frame_w

    def _attend_and_fuse(self, v, locations, weights, frame_w,
                         spatial_shapes):
        """One folded (B*T) msda call, the frame fusion, the output
        projection and its dropout."""
        B, T, N, H, D = v.shape
        Q = locations.shape[2]
        L, P = self.num_levels, self.num_points
        out = ms_deform_attn(
            v.reshape(B * T, N, H, D), spatial_shapes,
            locations.reshape(B * T, Q, H, L, P, 2),
            weights.reshape(B * T, Q, H, L, P))
        out = (out.view(B, T, Q, H, D) * frame_w[..., None]).sum(1)
        return self.drop(self.output_proj(out.reshape(B, Q, H * D)))


class MultiFrameDeformableAttention(_MultiFrameBase):
    """Joint-decoder cross-attention over T frames (P points)."""

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence, key_padding_mask=None,
                query_pos=None):
        """query (B,Q,C); value (B,T,N,C); reference_points (B,T,Q,L,2)
        per-frame points; mask (B,T,N)."""
        identity = query
        if query_pos is not None:
            query = query + query_pos
        v = self._project_value(value, key_padding_mask)
        offsets, weights, frame_w = self._frame_heads(query)
        locations = make_sampling_locations(reference_points, offsets,
                                            spatial_shapes)
        return identity + self._attend_and_fuse(v, locations, weights,
                                                frame_w, spatial_shapes)


class MultiFramePoseDeformableAttention(_MultiFrameBase):
    """Pose-decoder cross-attention: ``num_points`` = K keypoints."""

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence, key_padding_mask=None,
                query_pos=None):
        """query (B,Q,C); value (B,T,N,C); reference_points (B,T,Q,L,K*2);
        mask (B,T,N)."""
        identity = query
        if query_pos is not None:
            query = query + query_pos
        if reference_points.shape[-1] != self.num_points * 2:
            raise ValueError(
                f"pose attention needs K*2 references, got "
                f"{reference_points.shape[-1]} for K={self.num_points}")
        v = self._project_value(value, key_padding_mask)
        offsets, weights, frame_w = self._frame_heads(query)
        locations = pose_sampling_locations(reference_points, offsets)
        return identity + self._attend_and_fuse(v, locations, weights,
                                                frame_w, spatial_shapes)
