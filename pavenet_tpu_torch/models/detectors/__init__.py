from .videopose import VideoPoseDetector

__all__ = ["VideoPoseDetector"]
