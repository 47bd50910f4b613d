"""Encoder distillation (as ``pavenet_tpu/apis/distill.py``): a windowed-
encoder student learns the memory of a deformable-encoder teacher.

The student shares every state-dict entry outside ``head.encoder_layer*``
with the teacher (copied, and never updated) and trains only its encoder
layers to reproduce the teacher's ``(B, T, N, C)`` memory tokens. Both
models stop at the memory: the decoders do not run.

The update follows the JAX package's optax chain:

- ``clip_by_global_norm(grad_clip)`` over every gradient the loss reaches,
  the copied backbone, neck and ``level_embeds`` included;
- then AdamW (weight decay on every trained tensor) on ``head.encoder_layer*``
  only; the other parameters get no update.

Models built in bf16 (``dtype``) take part unchanged: the loss casts both
memories to float32, and a student built from a config takes the
teacher's activation dtype. A batch may be a ``dummy_clip_batch`` or a
``ClipLoader`` batch (a uint8 image is normalised on the card with the
state's ``img_norm``); ``DistillState.state_dict`` is what
``utils/checkpoint.py`` saves, so the student's checkpoint serves
``tools.test``.

Over ``torch.distributed`` ranks each rank takes its rows of the batch
with the teacher replicated, as the JAX step shards the batch: the MSE
and ``rel`` divide by the global batch's valid tokens and energy, the
gradient is summed over the ranks before the clip (a parameter the loss
did not reach counts as zeros), and the returned values are the global
batch's on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import torch

from ..models.detectors.videopose import VideoPoseDetector
from ..parallel import dist
from .inference import build_model
from .prep import IMG_NORM_MEAN, IMG_NORM_STD
from .train import model_feed


def _is_encoder_key(key: str) -> bool:
    # head.encoder_layer{i} only: a heatmap 'hm_encoder_layer' would be
    # shared like every other module
    return key.startswith("head.encoder_layer")


def student_from_teacher(student_state: Mapping[str, torch.Tensor],
                         teacher_state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The student's state dict with every entry outside
    ``head.encoder_layer*`` replaced by a copy of the teacher's. Raises
    ``KeyError`` on a student entry the teacher lacks and ``ValueError`` on
    a shape mismatch."""
    out = {}
    for key, value in student_state.items():
        if _is_encoder_key(key):
            out[key] = value
            continue
        if key not in teacher_state:
            raise KeyError(f"student entry {key!r} missing in the teacher")
        if teacher_state[key].shape != value.shape:
            raise ValueError(f"{key}: student {tuple(value.shape)} vs "
                             f"teacher {tuple(teacher_state[key].shape)}")
        out[key] = teacher_state[key].detach().clone()
    return out


def encoder_only_optimizer(model: VideoPoseDetector,
                           learning_rate: float = 1e-4,
                           weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """AdamW over ``head.encoder_layer*``; the rest is in no group."""
    params = [p for n, p in model.named_parameters() if _is_encoder_key(n)]
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def memory_distill_loss(student_memory: torch.Tensor,
                        teacher_memory: torch.Tensor,
                        mask_flatten: torch.Tensor):
    """Masked MSE of the student's memory against the (detached) teacher's,
    and the relative error ``rel`` against the teacher's token energy.

    mask_flatten (B, N), True = padding; padded tokens are left out. As in
    the JAX package the MSE divides by the valid tokens of one frame times
    C, while the sum runs over all T frames. Over ranks both denominators
    are the global batch's, so the ranks' values add up to its MSE and
    ``rel``.
    """
    mem_s = student_memory.float()
    mem_t = teacher_memory.detach().float()
    valid = (~mask_flatten)[:, None, :, None].float()
    se = ((mem_s - mem_t) ** 2 * valid).sum()
    mse = se / (dist.global_sum(valid.sum()) * mem_s.shape[-1] + 1e-6)
    rel = se / (dist.global_sum((mem_t ** 2 * valid).sum()) + 1e-6)
    return mse, rel


@dataclasses.dataclass
class DistillState:
    """Student, teacher, the student's encoder-only optimizer and clip, and
    the (mean, std) that normalises a uint8 feed."""
    student: VideoPoseDetector
    teacher: VideoPoseDetector
    optimizer: torch.optim.AdamW
    grad_clip: float
    step: int = 0
    img_norm: tuple = (IMG_NORM_MEAN, IMG_NORM_STD)

    def state_dict(self) -> dict:
        """The student's weights, under ``model`` as in a ``TrainState``'s
        (what ``utils/checkpoint.py::restore_variables`` reads)."""
        return dict(model=self.student.state_dict())


def create_distill_state(student: Union[str, Mapping, VideoPoseDetector],
                         teacher: VideoPoseDetector, seed: int = 0,
                         learning_rate: float = 1e-4,
                         grad_clip: float = 0.1,
                         img_norm=(IMG_NORM_MEAN, IMG_NORM_STD)
                         ) -> DistillState:
    """The student (a model, or a config built with a random init from
    ``seed`` in the teacher's activation dtype) with every shared entry
    copied from ``teacher``, on the teacher's device, and its encoder-only
    optimizer; ``img_norm`` normalises a uint8 feed."""
    if not isinstance(student, VideoPoseDetector):
        student = build_model(student, seed, dtype=teacher.dtype)
    student.load_state_dict(student_from_teacher(student.state_dict(),
                                                 teacher.state_dict()),
                            strict=True)
    student.to(next(teacher.parameters()).device)
    return DistillState(
        student=student, teacher=teacher,
        optimizer=encoder_only_optimizer(student, learning_rate),
        grad_clip=grad_clip, img_norm=tuple(img_norm))


def distill_step(state: DistillState,
                 batch: Mapping) -> Dict[str, torch.Tensor]:
    """One step: the teacher's memory without gradients, the student's
    memory with dropout off, the masked MSE, backward, the global-norm clip
    over every gradient and one AdamW update of the encoder layers.
    Returns the detached ``distill_mse``, ``distill_rel`` and
    ``grad_norm`` (the global norm the clip reads)."""
    student, teacher = state.student.eval(), state.teacher.eval()
    batch = model_feed(batch, next(student.parameters()).device,
                       state.img_norm)
    with torch.no_grad():
        target = teacher.forward_memory(batch["img"], batch["img_shape"])
    memory = student.forward_memory(batch["img"], batch["img_shape"])["memory"]
    mse, rel = memory_distill_loss(memory, target["memory"],
                                   target["mask_flatten"])
    student.zero_grad(set_to_none=True)
    mse.backward()
    if dist.active():
        params = list(student.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        dist.all_reduce_grads([p.grad for p in params])
    grads = [p.grad for p in student.parameters() if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < state.grad_clip, torch.ones_like(norm),
                        state.grad_clip / norm)
    for g in grads:
        g.mul_(scale)
    state.optimizer.step()
    student.zero_grad(set_to_none=True)
    state.step += 1
    logs = dist.all_reduce_scalars({"distill_mse": mse.detach(),
                                    "distill_rel": rel.detach()})
    return dict(logs, grad_norm=norm.detach())
