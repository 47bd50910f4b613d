from .resnet import ResNet

__all__ = ["ResNet"]
