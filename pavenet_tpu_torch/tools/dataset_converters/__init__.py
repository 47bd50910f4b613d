"""Annotation converters (``python -m
pavenet_tpu_torch.tools.dataset_converters.<name>``)."""
