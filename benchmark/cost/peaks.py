"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
# operations per second by the precision the matrix products run in:
# float32 outside the tensor cores, and the dense tensor-core rates
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
