from .ms_deform_attn import ms_deform_attn, ms_deform_attn_torch
from .nms import oks_iou_matrix, oks_nms_keep

__all__ = ["ms_deform_attn", "ms_deform_attn_torch", "oks_iou_matrix",
           "oks_nms_keep"]
