from .hrnet import HRNet
from .resnet import ResNet

__all__ = ["HRNet", "ResNet"]
