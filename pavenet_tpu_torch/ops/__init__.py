from .ms_deform_attn import ms_deform_attn, ms_deform_attn_torch
from .nms import oks_iou_matrix, oks_nms_keep
from .window_attn import window_attention, window_attention_torch

__all__ = ["ms_deform_attn", "ms_deform_attn_torch", "oks_iou_matrix",
           "oks_nms_keep", "window_attention", "window_attention_torch"]
