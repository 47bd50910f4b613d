"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` file is compiled with ``nvcc`` into a shared library with a
plain C entry point and bound with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The build happens at first use, into ``build/kernels/`` at
the root of the checkout; the library name carries a hash of the source, so
an edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


@functools.lru_cache(maxsize=None)
def _msda_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("msda_fwd")))
    lib.msda_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p])
    lib.msda_fwd.restype = ctypes.c_int
    return lib


def msda_fwd(value: torch.Tensor, shapes: torch.Tensor,
             level_start: torch.Tensor, loc: torch.Tensor,
             attn: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/msda_fwd.cu`` on the current stream.

    value ``(B,N,H,D)`` float32/bfloat16; shapes ``(L,2)`` and level_start
    ``(L,)`` int32; loc ``(B,Q,H,L,P,2)`` and attn ``(B,Q,H,L,P)`` float32.
    All on one CUDA device and contiguous. Returns ``(B,Q,H*D)`` in the
    value's dtype.
    """
    tensors = dict(value=value, shapes=shapes, level_start=level_start,
                   loc=loc, attn=attn)
    for k, t in tensors.items():
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"msda_fwd: {k} must be on {value.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"msda_fwd: {k} must be contiguous")
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"msda_fwd: value dtype {value.dtype} not supported")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("msda_fwd: loc and attn must be float32")
    if shapes.dtype != torch.int32 or level_start.dtype != torch.int32:
        raise TypeError("msda_fwd: shapes and level_start must be int32")
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError("msda_fwd: expected value (B,N,H,D), loc "
                         "(B,Q,H,L,P,2), attn (B,Q,H,L,P)")
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    if (loc.shape != (B, Q, H, L, P, 2) or attn.shape != (B, Q, H, L, P)
            or shapes.shape != (L, 2) or level_start.shape != (L,)):
        raise ValueError(
            f"msda_fwd: shape mismatch value {tuple(value.shape)}, loc "
            f"{tuple(loc.shape)}, attn {tuple(attn.shape)}, shapes "
            f"{tuple(shapes.shape)}, level_start {tuple(level_start.shape)}")
    if B * Q * H * D == 0:
        raise ValueError("msda_fwd: empty output")
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
    lib = _msda_lib()
    with torch.cuda.device(value.device):
        err = lib.msda_fwd(
            value.data_ptr(), shapes.data_ptr(), level_start.data_ptr(),
            loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[value.dtype], B, N, Q, H, D, L, P,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd launch failed: CUDA error {err}")
    return out
