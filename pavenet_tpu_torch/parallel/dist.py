"""Data parallelism over ``torch.distributed`` ranks (as
``pavenet_tpu/parallel/mesh.py``).

The JAX package shards the batch axis over a device mesh and computes the
loss over the *global* batch inside one jitted step: every loss normaliser
and trainable BatchNorm's batch statistics cover all devices, and XLA
inserts the gradient psum. Here each rank runs its own rows, and the same
semantics come from a few collectives:

- a loss divides its rank's numerator by the ``global_sum`` of the
  normaliser (the reference's ``reduce_mean``), so the ranks' shares add
  up to the loss of the global batch;
- trainable BatchNorm all-reduces its per-channel sums of ``x`` and
  ``x * x`` and its element count through ``global_sum_grad``, whose
  backward all-reduces the gradient;
- the train step sums the accumulated gradient over the ranks in one flat
  buffer (``all_reduce_grads``) before the clip.

With no process group every helper is the identity, and the callers keep
their single-process arithmetic exactly. The backend is the caller's
choice, never switched on failure: ``nccl`` where each rank has its own
card, ``gloo`` where the caller asks (CPU processes, or two ranks sharing
one card, where gloo all-reduces CUDA tensors through the host). The group
gets a timeout, so that a rank stuck in a collective fails its run.
"""
from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800.0


def _env_world() -> tuple:
    """(rank, world size, local rank) from torchrun's or SLURM's
    environment; (0, 1, 0) outside a launcher."""
    env = os.environ
    if "WORLD_SIZE" in env:
        return (int(env.get("RANK", 0)), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)))
    if env.get("SLURM_NTASKS", "1") not in ("", "0", "1"):
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)))
    return 0, 1, 0


def wanted() -> bool:
    """Whether the environment asks for a process group: torchrun's
    ``WORLD_SIZE`` above 1, a SLURM multi-task allocation, or
    ``PAVENET_DISTRIBUTED=1`` (a group even at world size 1)."""
    return (_env_world()[1] > 1
            or os.environ.get("PAVENET_DISTRIBUTED") == "1")


def maybe_init_distributed(logger=None, backend: Optional[str] = None,
                           device=None) -> bool:
    """Start the process group when the environment asks for one
    (``wanted``); otherwise a no-op that returns False.

    ``backend`` (default ``nccl``) is used as given. ``device`` is the
    rank's device (``resolve_device``); a CUDA one becomes the current
    device. The rendezvous is ``PAVENET_DIST_INIT``, else ``env://``
    (torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``); the rank and world
    size come from ``RANK`` and ``WORLD_SIZE`` or SLURM's variables, so a
    ``file://`` store needs no port. Every collective times out after
    ``PAVENET_DIST_TIMEOUT`` seconds (1800). A failed init raises. Returns
    True once a group is active."""
    if dist.is_initialized():
        return True
    if not wanted():
        return False
    rank_, world, local = _env_world()
    backend = backend or "nccl"
    device = resolve_device(device, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = float(os.environ.get("PAVENET_DIST_TIMEOUT",
                                   DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        backend=backend,
        init_method=os.environ.get("PAVENET_DIST_INIT", "env://"),
        rank=rank_, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    if logger is not None:
        logger.info(f"torch.distributed: rank {rank_}/{world}, backend "
                    f"{backend}, device {device}")
    return True


def resolve_device(device=None, local_rank: Optional[int] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``: None or a bare ``"cuda"`` is the
    rank's own card, ``cuda:LOCAL_RANK``; an explicit one (``"cuda:0"``,
    ``"cpu"``) is kept."""
    if local_rank is None:
        local_rank = _env_world()[2]
    if device is None or str(device) == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device(device)


def active() -> bool:
    """Whether a process group is initialised (the collectives run)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def backend() -> Optional[str]:
    """The group's backend, None with no group."""
    return dist.get_backend() if active() else None


def is_main() -> bool:
    """Rank 0, the rank that writes logs, metrics and checkpoints."""
    return rank() == 0


def barrier():
    if active():
        dist.barrier()


def destroy():
    """End the process group, if any."""
    if active():
        dist.destroy_process_group()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a detached all-reduce on a copy);
    ``t`` itself with no group."""
    if not active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (SUM) whose backward all-reduces the gradient: the
    gradient of every rank's loss reaches every rank's input."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def global_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``global_sum`` that gradients flow through (trainable BatchNorm's
    statistics); ``t`` itself with no group."""
    return _SumOverRanks.apply(t) if active() else t


def all_reduce_grads(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Sum ``tensors`` over the ranks in place, through one flat buffer
    (every rank must pass the same shapes in the same order); a no-op with
    no group."""
    tensors = list(tensors)
    if not active() or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def all_reduce_scalars(values: dict) -> dict:
    """A dict of scalar tensors summed over the ranks in one all-reduce
    (the keys in the same order on every rank); the dict itself with no
    group."""
    if not active() or not values:
        return values
    keys = list(values)
    dtype = torch.float32
    for v in values.values():
        dtype = torch.promote_types(dtype, v.dtype)
    flat = global_sum(torch.stack([values[k].detach().to(dtype).reshape(())
                                   for k in keys]))
    return {k: flat[i].to(values[k].dtype) for i, k in enumerate(keys)}
