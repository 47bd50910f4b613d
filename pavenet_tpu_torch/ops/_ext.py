"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` file is compiled with ``nvcc`` into a shared library with a
plain C entry point and bound with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The build happens at first use, into ``build/kernels/`` at
the root of the checkout; the library name carries a hash of the source and
of the headers in ``csrc/``, so an edited source is rebuilt and a stale
library is never loaded.
"""
from __future__ import annotations

import collections
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("msda_fwd", "msda_bwd", "window_attn_fwd", "window_attn_bwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# ctypes signatures: pointers (and the stream) as c_void_p, ints as c_int
_MSDA_INTS = [ctypes.c_int] * 10   # L, dtype, B, N, Q, H, D, P, chunk, threads
_ARGTYPES = {
    # value, loc, attn, out, the level table (host array)
    "msda_fwd": [ctypes.c_void_p] * 5 + _MSDA_INTS + [ctypes.c_void_p],
    # value, loc, attn, grad_out, grad_value, grad_loc, grad_attn, levels
    "msda_bwd": [ctypes.c_void_p] * 8 + _MSDA_INTS + [ctypes.c_void_p],
    # n_levels, the level table's pointers and dims (host arrays), windows,
    # dtype, C, num_heads, wh, ww
    "window_attn_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "window_attn_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}
# msda: head sizes the kernels are compiled for (csrc/msda_common.cuh
# MSDA_FOR_EACH_HEAD_DIM: SOIT's and DK-DETR's 2-channel dynamic mask
# heads, the edge case, the tiny configs, the flagship and the other powers
# of two up to SOIT's 256), the most levels of one call,
# what the plan may give a block (Hopper's 227 KB of shared memory less the
# kernels' 128-byte level table) and an SM (228 KB), and the blocks a call
# is cut into per direction (4 and 8 per SM of the H100's 132: the
# backward's smaller chunks spread its reductions)
MSDA_HEAD_DIMS = (2, 4, 8, 16, 32, 64, 128, 256)
MSDA_MAX_LEVELS = 8
MSDA_SMEM_BYTES = 232448 - 128
MSDA_SM_SMEM_BYTES = 233472
MSDA_BLOCKS_PER_CALL = {False: 4 * 132, True: 8 * 132}
# head sizes the window-attention kernels are compiled for, both directions
# and dtypes: the tiny debug configs' 64 / 8, 128 / 8, the flagship's 256 / 8
# and 512 / 8; the window is 128 tokens and one launch takes at most
# WINDOW_MAX_LEVELS level rasters
WINDOW_HEAD_DIMS = (8, 16, 32, 64)
WINDOW_TOKENS = 128
WINDOW_MAX_LEVELS = 8


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
    """The library of ``csrc/<name>.cu``, named by a hash of that source and
    of every header in ``csrc/``."""
    sha = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    digest = sha.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together; the compiler's output (with ptxas's
    registers, shared memory and spills per kernel) is kept beside each
    library (:func:`build_log`). Returns ``{name: seconds}`` of each build
    that ran (0.0 for one already built)."""
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
            _lib_path(name).with_suffix(".log").write_text(log.read())
        os.replace(tmp, _lib_path(name))  # atomic: no half-written library
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the build of ``csrc/<name>.cu`` ("" if it
    was not built in this checkout)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


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


MsdaPlan = collections.namedtuple("MsdaPlan", "chunk threads levels smem")
MsdaPlan.__doc__ = """A call's work partition: ``chunk`` queries of one
(b, h) per block, ``threads`` per block, ``levels`` the (H_l, W_l, first
row in the block's shared table or -1) of each level, ``smem`` the bytes
of that table."""


@functools.lru_cache(maxsize=256)
def msda_plan(shapes, B: int, Q: int, H: int, P: int, D: int, dtype,
              backward: bool = False,
              smem_bytes: int = MSDA_SMEM_BYTES) -> MsdaPlan:
    """Plan one msda launch (pure: the CPU tests check it).

    The call is cut into about ``MSDA_BLOCKS_PER_CALL[backward]`` blocks,
    each one (b, h) and a chunk of consecutive queries. Levels are staged
    in the block's shared memory coarsest first (the value rows in the
    value's dtype forward, an f32 gradient table backward) while the taps
    of a block on the level (``chunk * P``) outnumber its rows and the
    table stays within ``smem_bytes`` (at most ``MSDA_SMEM_BYTES``); the
    other levels are read (and reduced) through L1. Rows narrower than a
    lane's 16-byte f32 vector (D=2, the dynamic mask call) are not staged
    by the taps' count: the forward stages nothing, since copying a level
    costs a 32-byte sector per row and a whole SM's shared memory, and the
    backward stages every level that fits, since its shared table then
    takes every reduction (on an H100 each beat the other choice at the
    mask call's serve and train shapes, by 1.3-2.1 times forward and
    1.13-1.20 backward). Blocks are sized by ``msda_partition``.
    """
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    L = len(shapes)
    if not 1 <= L <= MSDA_MAX_LEVELS:
        raise ValueError(f"msda: {L} levels, not 1..{MSDA_MAX_LEVELS}")
    if D not in MSDA_HEAD_DIMS:
        raise ValueError(f"msda: head size {D} not in {MSDA_HEAD_DIMS}, the "
                         "head sizes the kernels take")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"msda: value dtype {dtype} not supported")
    if not 0 <= smem_bytes <= MSDA_SMEM_BYTES:
        raise ValueError(f"msda: {smem_bytes} bytes of shared memory, not "
                         f"0..{MSDA_SMEM_BYTES}")
    if min(B, Q, H, P) < 1 or min(min(s) for s in shapes) < 1:
        raise ValueError(f"msda: empty call B={B} Q={Q} H={H} P={P} "
                         f"levels {shapes}")
    row_bytes = _msda_row_bytes(D, dtype, backward)
    narrow = D * 4 < 16
    chunks = max(1, -(-MSDA_BLOCKS_PER_CALL[backward] // (B * H)))
    chunk = -(-Q // chunks)
    staged, rows = [], 0
    for l in sorted(range(L), key=lambda l: shapes[l][0] * shapes[l][1]):
        n = shapes[l][0] * shapes[l][1]
        wanted = backward if narrow else chunk * P > n
        if not wanted or (rows + n) * row_bytes > smem_bytes:
            break
        staged.append(l)
        rows += n
    return msda_partition(shapes, chunk, tuple(staged), D, dtype, backward)


def _msda_row_bytes(D: int, dtype, backward: bool) -> int:
    """Bytes of a staged row: the value's dtype forward, f32 gradient rows
    backward."""
    return D * (4 if backward or dtype == torch.float32 else 2)


def msda_partition(shapes, chunk: int, staged, D: int, dtype,
                   backward: bool = False) -> MsdaPlan:
    """The plan of ``chunk`` queries a block that stages the levels
    ``staged`` (indices, packed in that order into the block's table).

    The kernels hold 64 registers a thread, so an SM runs 1024 threads: a
    block takes 1024 over the number of blocks the SM's shared memory
    holds (228 KB, 1 KB of it reserved per block, at most 4), in whole
    warps, and never more than its chunk's lanes need (a lane owns 8
    channels forward, 4 backward, where the backward takes wide heads 32
    channels a pass)."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    row_bytes = _msda_row_bytes(D, dtype, backward)
    lanes = (min(D, 32) // min(D, 4) if backward     # lanes per (b, q, h)
             else D // min(D, 8))
    smem_row, rows = [-1] * len(shapes), 0
    for l in staged:
        smem_row[l], rows = rows, rows + shapes[l][0] * shapes[l][1]
    smem = rows * row_bytes
    blocks = min(4, MSDA_SM_SMEM_BYTES // (smem + 128 + 1024))
    threads = min(1024 // blocks // 32 * 32, -(-chunk * lanes // 32) * 32)
    return MsdaPlan(chunk, threads,
                    tuple(zip(*zip(*shapes), smem_row)), smem)


def _check_msda(name: str, value, shapes, loc, attn, **more):
    """Check one msda launch's operands; returns (B, N, Q, H, D, L, P)."""
    device = value.get_device()
    tensors = dict(value=value, loc=loc, attn=attn, **more)
    for key, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte "
                             "aligned")
    for key, t in tensors.items():
        if device < 0 or t.get_device() != device:
            raise ValueError(f"{name}: {key} must be on {value.device} (a "
                             f"CUDA device), got {t.device}")
        if key != "value" and t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError(f"{name}: expected value (B,N,H,D), loc "
                         "(B,Q,H,L,P,2), attn (B,Q,H,L,P)")
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    if (loc.shape != (B, Q, H, L, P, 2) or attn.shape != (B, Q, H, L, P)
            or len(shapes) != L or sum(h * w for h, w in shapes) != N):
        raise ValueError(
            f"{name}: shape mismatch value {tuple(value.shape)}, loc "
            f"{tuple(loc.shape)}, attn {tuple(attn.shape)}, levels "
            f"{tuple(shapes)}")
    if B * H > 65535 or N >= 1 << 24:
        raise ValueError(f"{name}: B * H = {B * H} or N = {N} exceeds what "
                         "the kernels index (65535, 2^24 - 1)")
    return B, N, Q, H, D, L, P


def msda_args(name: str, value, shapes, loc, attn, backward=False,
              smem_bytes=MSDA_SMEM_BYTES, plan=None, **more):
    """Check one msda launch; returns its C arguments after the tensors:
    the level table (a host array), L, dtype, B, N, Q, H, D, P, chunk,
    threads (``plan``, by default that of ``msda_plan``)."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    B, N, Q, H, D, L, P = _check_msda(name, value, shapes, loc, attn,
                                      **more)
    if plan is None:
        plan = msda_plan(shapes, B, Q, H, P, D, value.dtype, backward,
                         smem_bytes)
    flat = [x for level in plan.levels for x in level]
    return ((ctypes.c_int * len(flat))(*flat), L, _DTYPE_CODES[value.dtype],
            B, N, Q, H, D, P, plan.chunk, plan.threads)


def _launch(name: str, device, *args):
    fn = getattr(_load(name), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def msda_fwd(value: torch.Tensor, shapes, loc: torch.Tensor,
             attn: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/msda_fwd.cu`` on the current stream.

    value ``(B,N,H,D)`` float32/bfloat16, D in ``MSDA_HEAD_DIMS``; shapes
    the levels' ``((H_0, W_0), ...)``; loc ``(B,Q,H,L,P,2)`` and attn
    ``(B,Q,H,L,P)`` float32. All on one CUDA device, contiguous and 16-byte
    aligned. Returns ``(B,Q,H*D)`` in the value's dtype.
    """
    args = msda_args("msda_fwd", value, shapes, loc, attn)
    B, _, H, D = value.shape
    out = torch.empty((B, loc.shape[1], H * D), dtype=value.dtype,
                      device=value.device)
    _launch("msda_fwd", value.device, value.data_ptr(), loc.data_ptr(),
            attn.data_ptr(), out.data_ptr(), *args)
    return out


def msda_bwd(value: torch.Tensor, shapes, loc: torch.Tensor,
             attn: torch.Tensor, grad_out: torch.Tensor):
    """Launch ``csrc/msda_bwd.cu`` on the current stream.

    Inputs as ``msda_fwd`` plus grad_out ``(B,Q,H*D)`` float32. Returns
    ``(grad_value, grad_loc, grad_attn)``: grad_value in the value's dtype
    (summed in a float32 scratch), grad_loc and grad_attn float32.
    """
    args = msda_args("msda_bwd", value, shapes, loc, attn, backward=True,
                     grad_out=grad_out)
    B, N, H, D = value.shape
    if grad_out.shape != (B, loc.shape[1], H * D):
        raise ValueError(f"msda_bwd: grad_out {tuple(grad_out.shape)} is "
                         f"not {(B, loc.shape[1], H * D)}")
    grad_value = torch.zeros((B, N, H, D), dtype=torch.float32,
                             device=value.device)
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    _launch("msda_bwd", value.device, value.data_ptr(), loc.data_ptr(),
            attn.data_ptr(), grad_out.data_ptr(), grad_value.data_ptr(),
            grad_loc.data_ptr(), grad_attn.data_ptr(), *args)
    return grad_value.to(value.dtype), grad_loc, grad_attn


def window_level_table(shapes, wh: int = 8, ww: int = 16):
    """The level table of one window-attention launch: for each level's
    ``(B, Hp, Wp)`` its ``(B, Hp, Wp, first)``, where ``first`` is the
    launch-wide index of its first window (windows run level by level, then
    batch, window row, window column), and the total number of windows."""
    table, first = [], 0
    for B, Hp, Wp in shapes:
        if Hp % wh or Wp % ww or B * Hp * Wp == 0:
            raise ValueError(f"raster {B}x{Hp}x{Wp} is empty or not a "
                             f"multiple of the ({wh}, {ww}) window")
        table.append((B, Hp, Wp, first))
        first += B * (Hp // wh) * (Wp // ww)
    return table, first


def _check_window(name: str, qs, num_heads: int, wh: int, ww: int,
                  **lists):
    """Check the level lists of a window-attention launch; returns
    ``(C, level table, total windows)``."""
    n = len(qs)
    if not 1 <= n <= WINDOW_MAX_LEVELS:
        raise ValueError(f"{name}: {n} levels, not 1..{WINDOW_MAX_LEVELS}")
    if wh * ww != WINDOW_TOKENS:
        raise ValueError(f"{name}: the kernels take {WINDOW_TOKENS}-token "
                         f"windows, not ({wh}, {ww})")
    q0 = qs[0]
    if q0.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q0.dtype} not supported")
    if q0.dim() != 4:
        raise ValueError(f"{name}: expected (B, Hp, Wp, C) rasters, got "
                         f"{tuple(q0.shape)}")
    C = q0.shape[3]
    if C % num_heads or C // num_heads not in WINDOW_HEAD_DIMS:
        raise ValueError(f"{name}: head size C / num_heads = {C} / "
                         f"{num_heads} not in {WINDOW_HEAD_DIMS}, the head "
                         "sizes the kernel takes")
    for key, ts in lists.items():
        if len(ts) != n:
            raise ValueError(f"{name}: {len(ts)} {key} for {n} levels")
    # one launch checks up to 8 levels x 8 tensors on the host, so these are
    # the cheap properties (get_device, not device)
    device = q0.get_device()
    shapes = []
    for level, q in enumerate(qs):
        shape = q.shape
        if len(shape) != 4 or shape[3] != C:
            raise ValueError(f"{name}: level {level} q {tuple(shape)} is "
                             f"not a (B, Hp, Wp, {C}) raster")
        shapes.append(shape[:3])
        for key, t in (("q", q), *((k, ts[level]) for k, ts in
                                   lists.items())):
            if device < 0 or t.get_device() != device:
                raise ValueError(f"{name}: {key} must be on {q0.device} (a "
                                 f"CUDA device), got {t.device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name}: {key} must be contiguous and "
                                 "16-byte aligned")
            want = torch.float32 if key == "keep" else q0.dtype
            if t.dtype != want:
                raise TypeError(f"{name}: {key} must be {want}, got "
                                f"{t.dtype}")
            if t.shape != (shapes[-1] if key == "keep" else shape):
                raise ValueError(f"{name}: level {level} {key} "
                                 f"{tuple(t.shape)} is not the raster's")
    table, windows = window_level_table(shapes, wh, ww)
    return C, table, windows


def _window_launch(name, qs, per_level, table, windows, C, num_heads, wh,
                   ww):
    ptrs = [t.data_ptr() for tensors in per_level for t in tensors]
    dims = [d for _, Hp, Wp, first in table for d in (Hp, Wp, first)]
    _launch(name, qs[0].device, len(qs), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(dims))(*dims), windows,
            _DTYPE_CODES[qs[0].dtype], C, num_heads, wh, ww)


def window_attn_fwd(qs, ks, vs, keeps, num_heads: int, wh: int = 8,
                    ww: int = 16):
    """Launch ``csrc/window_attn_fwd.cu`` once over every level raster.

    qs, ks, vs: per level ``(B, Hp, Wp, C)`` float32 or bfloat16 (one dtype
    and C for all); keeps: per level ``(B, Hp, Wp)`` float32 0/1; all on one
    CUDA device, contiguous. Returns the per-level outputs in q's dtype.
    """
    C, table, windows = _check_window("window_attn_fwd", qs, num_heads, wh,
                                      ww, k=ks, v=vs, keep=keeps)
    outs = [torch.empty_like(q) for q in qs]
    _window_launch("window_attn_fwd", qs, zip(qs, ks, vs, keeps, outs),
                   table, windows, C, num_heads, wh, ww)
    return outs


def window_attn_bwd(qs, ks, vs, keeps, gs, num_heads: int, wh: int = 8,
                    ww: int = 16):
    """Launch ``csrc/window_attn_bwd.cu`` once over every level raster.

    Inputs as ``window_attn_fwd`` plus the output gradients gs in q's
    dtype. Returns ``(dqs, dks, dvs)``, per-level lists in q's dtype.
    """
    C, table, windows = _check_window("window_attn_bwd", qs, num_heads, wh,
                                      ww, k=ks, v=vs, keep=keeps, g=gs)
    dqs, dks, dvs = ([torch.empty_like(q) for q in qs] for _ in range(3))
    _window_launch("window_attn_bwd", qs,
                   zip(qs, ks, vs, gs, keeps, dqs, dks, dvs), table, windows,
                   C, num_heads, wh, ww)
    return dqs, dks, dvs
