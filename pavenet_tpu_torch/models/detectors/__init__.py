from .inspose import InsPoseDetector
from .soit import SOITDetector
from .videopose import VideoPoseDetector

__all__ = ["InsPoseDetector", "SOITDetector", "VideoPoseDetector"]
