"""Demos of the port (``python -m pavenet_tpu_torch.demo.image_demo``)."""
