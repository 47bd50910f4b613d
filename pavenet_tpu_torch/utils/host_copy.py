"""A detector's outputs to the host through page-locked memory.

``to_host`` copies a dict of CUDA tensors into pinned host tensors of the
same shape and dtype, drawn from PyTorch's caching host allocator: a
block a caller has dropped goes, still mapped and pinned, to the next
request of its size, so only the first request of a size, and each output
a caller keeps alive, pays for ``cudaHostAlloc``. The DMA engine writes
straight into the destination; a pageable destination would be faulted
in page by page and staged through the driver's small pinned buffer.

Every call returns tensors that own their storage: nothing is reused
while a caller holds it.
"""
from __future__ import annotations

import time
from typing import Dict

import torch


def to_host(outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``outputs`` on the host. Where they are on a CUDA device (all on
    one), each is copied into a new pinned host tensor on the current
    stream, without blocking, and the call returns once the stream has
    reached the last copy; any other dict is returned as it is, the same
    tensor objects.

    Counters: ``to_host.copies`` (calls that copied), ``.bytes`` (bytes
    copied), ``.seconds`` (host clock from the first copy issued to the
    wait's end, device work still queued ahead of the copies included)."""
    device = next(iter(outputs.values())).device
    if device.type != "cuda":
        return outputs
    host = {k: torch.empty(v.shape, dtype=v.dtype, device="cpu",
                           pin_memory=True)
            for k, v in outputs.items()}
    t0 = time.perf_counter()
    for k, v in outputs.items():
        host[k].copy_(v, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    to_host.copies += 1
    to_host.bytes += sum(v.nbytes for v in host.values())
    to_host.seconds += time.perf_counter() - t0
    return host


to_host.copies = 0
to_host.bytes = 0
to_host.seconds = 0.0
