"""pavenet_tpu_torch: the PAVE-Net clip-inference path, train step and
dataset-to-AP CLIs in PyTorch, with the PETR family (PETR on COCO and
CrowdPose, HRNet-W48, video pretraining on COCO clips), and hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``pavenet_tpu`` is the reference this port is held against;
this package imports none of it and never JAX: the host modules it needs
(config loader, registry, pipelines, evaluators) are its own copies.
"""
__version__ = "0.2.0"
