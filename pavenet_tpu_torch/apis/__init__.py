from .inference import inference_detector, init_detector

__all__ = ["init_detector", "inference_detector"]
