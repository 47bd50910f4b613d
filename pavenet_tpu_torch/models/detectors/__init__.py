from .soit import SOITDetector
from .videopose import VideoPoseDetector

__all__ = ["SOITDetector", "VideoPoseDetector"]
