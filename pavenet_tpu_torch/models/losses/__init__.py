from .focal_loss import (center_focal_loss, sigmoid_focal_loss,
                         varifocal_loss)
from .oks_loss import OKS_SIGMAS, oks_loss, oks_overlaps
from .rle_loss import rle_loss

__all__ = ["center_focal_loss", "sigmoid_focal_loss", "varifocal_loss",
           "OKS_SIGMAS", "oks_loss", "oks_overlaps", "rle_loss"]
