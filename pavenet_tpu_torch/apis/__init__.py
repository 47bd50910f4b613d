from .distill import create_distill_state, distill_step
from .inference import build_model, inference_detector, init_detector
from .train import init_trainer, train_step

__all__ = ["build_model", "create_distill_state", "distill_step",
           "init_detector", "inference_detector", "init_trainer",
           "train_step"]
