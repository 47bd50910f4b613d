"""pavenet_tpu_torch: the PAVE-Net clip-inference path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``pavenet_tpu`` is the reference this port is held against;
this package imports only its framework-free host modules (config and data
pipeline) and never JAX.
"""
__version__ = "0.1.0"
