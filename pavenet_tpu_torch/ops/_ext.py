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
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("msda_fwd", "msda_bwd", "window_attn_fwd", "window_attn_bwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# ctypes signatures: pointers (and the stream) as c_void_p, ints as c_int
_ARGTYPES = {
    "msda_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                + [ctypes.c_void_p],
    "msda_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                + [ctypes.c_void_p],
    "window_attn_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p],
    "window_attn_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p],
}
# head sizes the window-attention kernels are compiled for: the flagship's
# 256 / 8 and the tiny debug configs' 64 / 8
WINDOW_HEAD_DIMS = (8, 32)


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


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: seconds}`` of each
    build that ran (0.0 for one already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, seconds = {}, {}
    start = time.perf_counter()
    for name in names:
        lib = _lib_path(name)
        seconds[name] = 0.0
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = tempfile.TemporaryFile("w+")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True))
    pending = set(jobs)
    while pending:
        for name in list(pending):
            if jobs[name][2].poll() is not None:
                seconds[name] = time.perf_counter() - start
                pending.discard(name)
        time.sleep(0.02)
    for name, (tmp, log, proc) in jobs.items():
        with log:
            log.seek(0)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.read()}")
        os.replace(tmp, _lib_path(name))  # atomic: no half-written library
    return seconds


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the path."""
    build_all((name,))
    return _lib_path(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, value: torch.Tensor, **tensors):
    for k, t in dict(value=value, **tensors).items():
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{name}: {k} must be on {value.device} "
                             f"(a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if k not in ("value", "shapes", "level_start") and (
                t.dtype != torch.float32):
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: value dtype {value.dtype} not supported")
    shapes, level_start = tensors["shapes"], tensors["level_start"]
    if shapes.dtype != torch.int32 or level_start.dtype != torch.int32:
        raise TypeError(f"{name}: shapes and level_start must be int32")
    loc, attn = tensors["loc"], tensors["attn"]
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(f"{name}: expected value (B,N,H,D), loc "
                         "(B,Q,H,L,P,2), attn (B,Q,H,L,P)")
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    if (loc.shape != (B, Q, H, L, P, 2) or attn.shape != (B, Q, H, L, P)
            or shapes.shape != (L, 2) or level_start.shape != (L,)):
        raise ValueError(
            f"{name}: shape mismatch value {tuple(value.shape)}, loc "
            f"{tuple(loc.shape)}, attn {tuple(attn.shape)}, shapes "
            f"{tuple(shapes.shape)}, level_start {tuple(level_start.shape)}")
    if B * Q * H * D == 0:
        raise ValueError(f"{name}: empty output")
    return B, N, Q, H, D, L, P


def _launch(name: str, device, *args):
    fn = getattr(_load(name), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def msda_fwd(value: torch.Tensor, shapes: torch.Tensor,
             level_start: torch.Tensor, loc: torch.Tensor,
             attn: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/msda_fwd.cu`` on the current stream.

    value ``(B,N,H,D)`` float32/bfloat16; shapes ``(L,2)`` and level_start
    ``(L,)`` int32; loc ``(B,Q,H,L,P,2)`` and attn ``(B,Q,H,L,P)`` float32.
    All on one CUDA device and contiguous. Returns ``(B,Q,H*D)`` in the
    value's dtype.
    """
    B, N, Q, H, D, L, P = _check("msda_fwd", value, shapes=shapes,
                                 level_start=level_start, loc=loc, attn=attn)
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
    _launch("msda_fwd", value.device, value.data_ptr(), shapes.data_ptr(),
            level_start.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[value.dtype], B, N, Q, H, D, L, P)
    return out


def msda_bwd(value: torch.Tensor, shapes: torch.Tensor,
             level_start: torch.Tensor, loc: torch.Tensor,
             attn: torch.Tensor, grad_out: torch.Tensor):
    """Launch ``csrc/msda_bwd.cu`` on the current stream.

    Inputs as ``msda_fwd`` plus grad_out ``(B,Q,H*D)`` float32. Returns
    ``(grad_value, grad_loc, grad_attn)``: grad_value in the value's dtype
    (summed in a float32 scratch), grad_loc and grad_attn float32.
    """
    B, N, Q, H, D, L, P = _check("msda_bwd", value, shapes=shapes,
                                 level_start=level_start, loc=loc, attn=attn,
                                 grad_out=grad_out)
    if grad_out.shape != (B, Q, H * D):
        raise ValueError(f"msda_bwd: grad_out {tuple(grad_out.shape)} is "
                         f"not {(B, Q, H * D)}")
    grad_value = torch.zeros((B, N, H, D), dtype=torch.float32,
                             device=value.device)
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    _launch("msda_bwd", value.device, value.data_ptr(), shapes.data_ptr(),
            level_start.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            grad_out.data_ptr(), grad_value.data_ptr(), grad_loc.data_ptr(),
            grad_attn.data_ptr(), _DTYPE_CODES[value.dtype], B, N, Q, H, D,
            L, P)
    return grad_value.to(value.dtype), grad_loc, grad_attn


def _check_window(name: str, q: torch.Tensor, num_heads: int, wh: int,
                  ww: int, **tensors):
    for k, t in dict(q=q, **tensors).items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {k} must be on {q.device} (a CUDA "
                             f"device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        want = torch.float32 if k == "keep" else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {k} must be {want}, got {t.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if q.dim() != 4:
        raise ValueError(f"{name}: expected (B, Hp, Wp, C) rasters, got "
                         f"{tuple(q.shape)}")
    B, Hp, Wp, C = q.shape
    for k, t in tensors.items():
        want = (B, Hp, Wp) if k == "keep" else (B, Hp, Wp, C)
        if t.shape != want:
            raise ValueError(f"{name}: {k} {tuple(t.shape)} is not {want}")
    if Hp % wh or Wp % ww or B * Hp * Wp == 0:
        raise ValueError(f"{name}: raster {Hp}x{Wp} is empty or not a "
                         f"multiple of the ({wh}, {ww}) window")
    if wh * ww > 1024:
        raise ValueError(f"{name}: window of {wh * ww} tokens > 1024")
    if C % num_heads or C // num_heads not in WINDOW_HEAD_DIMS:
        raise ValueError(f"{name}: head size C / num_heads = {C} / "
                         f"{num_heads} not in {WINDOW_HEAD_DIMS}")
    return B, Hp, Wp, C


def window_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep: torch.Tensor, num_heads: int, wh: int = 8,
                    ww: int = 16) -> torch.Tensor:
    """Launch ``csrc/window_attn_fwd.cu`` on the current stream.

    q, k, v ``(B, Hp, Wp, C)`` float32 or bfloat16 (one dtype), keep
    ``(B, Hp, Wp)`` float32 0/1; all on one CUDA device and contiguous.
    Returns ``(B, Hp, Wp, C)`` in q's dtype.
    """
    B, Hp, Wp, C = _check_window("window_attn_fwd", q, num_heads, wh, ww,
                                 k=k, v=v, keep=keep)
    out = torch.empty_like(q)
    _launch("window_attn_fwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), keep.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Hp, Wp, C, num_heads, wh, ww)
    return out


def window_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep: torch.Tensor, grad_out: torch.Tensor,
                    num_heads: int, wh: int = 8, ww: int = 16):
    """Launch ``csrc/window_attn_bwd.cu`` on the current stream.

    Inputs as ``window_attn_fwd`` plus grad_out ``(B, Hp, Wp, C)`` in q's
    dtype. Returns ``(dq, dk, dv)`` in q's dtype.
    """
    B, Hp, Wp, C = _check_window("window_attn_bwd", q, num_heads, wh, ww,
                                 k=k, v=v, keep=keep, grad_out=grad_out)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("window_attn_bwd", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), keep.data_ptr(), grad_out.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Hp, Wp, C, num_heads, wh, ww)
    return dq, dk, dv
