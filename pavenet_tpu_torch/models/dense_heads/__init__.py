from .videopose_head import VideoPoseHead

__all__ = ["VideoPoseHead"]
