from .focal_loss import sigmoid_focal_loss
from .oks_loss import OKS_SIGMAS
from .rle_loss import rle_loss

__all__ = ["sigmoid_focal_loss", "OKS_SIGMAS", "rle_loss"]
