"""Train step (as ``pavenet_tpu/apis/train.py`` and the optimizer setup of
``tools/train.py``): parameter groups, the mmcv lr schedule, and AdamW with
global-norm clipping and gradient accumulation.

The JAX package runs ``optax.MultiSteps(chain(clip_by_global_norm,
multi_transform({base, backbone, backbone_norm, slow: adamw, frozen:
set_to_zero})))``. Its semantics, kept here:

- the clip norm is taken over every gradient, the frozen parameters' ones
  included (stem, ``layer1`` and every frozen BatchNorm affine); frozen
  parameters then get no update and no weight decay;
- the k mini-batch gradients are averaged (a running mean) and one AdamW
  update is applied every k-th mini-batch;
- the lr schedule counts applied updates, not mini-batches;
- weight decay 1e-4 on every trained parameter, biases, norms and
  embeddings included (decoupled, as ``torch.optim.AdamW``), except the
  affines of trainable BatchNorm (``backbone_norm``: backbone lr, no decay);
- trainable BatchNorm updates its running statistics in every mini-step's
  forward, whether the step applies an update or only accumulates;
- parameters and optimizer state stay float32 whatever the model's
  activation dtype;
- with an ``EMAHook`` in the config's ``custom_hooks``, an exponential
  moving average of the parameters, ``e * d + p * (1 - d)`` with
  ``d = 1 - momentum``, follows every mini-step (as ``make_train_step``'s
  ``ema_decay``).

The same step trains every detector the builder makes. A pose batch is a
``dummy_clip_batch`` or a ``datasets/loader.py::ClipLoader`` batch; a
detection batch (SOIT, DK-DETR) holds ``img`` (B, H, W, 3), ``img_shape``,
``gt_boxes``, ``gt_labels``, ``gt_masks``, ``gt_valid`` and, for DK-DETR,
``text_feats`` (``models/detectors/soit.py``); an InsPose batch ``img`` (B,
H, W, 3), ``img_shape``, ``gt_boxes``, ``gt_keypoints`` and ``gt_valid``
(``models/detectors/inspose.py``). Only the keys the model
reads go to the device (``feed_keys``), and a uint8 image is normalised
there (``apis/prep.py``, with the mean and std
of the config's ``train_pipeline_kwargs``). ``TrainState.state_dict``
holds the whole run (model, optimizer, counts, accumulated gradient, EMA,
dropout generator) for ``utils/checkpoint.py``.

Over ``torch.distributed`` ranks (``parallel/dist.py``) the step keeps the
JAX package's global-batch semantics: each rank runs its rows with the
losses normalised by the global batch and trainable BatchNorm's statistics
taken over it (``models/``), the accumulated gradient is summed over the
ranks in one flat buffer before the clip (a parameter no loss reached on a
rank counts as zeros there, so every rank sends the same buffer), the
returned losses are summed the same way, and the clip, AdamW and the EMA
then run identically on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..config import Config
from ..models.detectors.inspose import InsPoseDetector
from ..models.detectors.soit import SOITDetector
from ..models.layers.transformer import Dropout
from ..parallel import dist
from .inference import build_model
from .prep import IMG_NORM_MEAN, IMG_NORM_STD, device_prep

# the batch keys the model reads, in training and in serving; a model with
# PETR's heatmap loss reads ``gt_bboxes`` too, DK-DETR ``text_feats``
# (``feed_keys``)
MODEL_KEYS = ("img", "img_shape", "scale_factor", "gt_keypoints",
              "gt_areas", "gt_valid")
DET_KEYS = ("img", "img_shape", "scale_factor", "gt_boxes", "gt_labels",
            "gt_masks", "gt_valid")
INSPOSE_KEYS = ("img", "img_shape", "scale_factor", "gt_boxes",
                "gt_keypoints", "gt_valid")


def _param_label(name: str, frozen_stages: int = 1,
                 freeze_backbone_neck: bool = False,
                 trainable_bn: bool = False) -> str:
    """Optimizer group of a parameter from its dotted name, by the JAX
    package's rule on the parameter path: 'frozen', 'backbone' (backbone
    lr), 'backbone_norm' (trainable BatchNorm affines: backbone lr, no
    weight decay), 'slow' (offsets, lr x0.1) or 'base'."""
    keys = name.split(".")
    if freeze_backbone_neck and ("backbone" in keys or "neck" in keys):
        return "frozen"       # VideoPoseV2
    if "backbone" in keys:
        # only the backbone's direct child decides: every block has inner
        # conv1/bn1 modules that must not match
        child = keys[keys.index("backbone") + 1]
        if frozen_stages >= 0 and child.startswith(("conv1", "bn1")):
            return "frozen"
        if any(child.startswith(f"layer{s}_")
               for s in range(1, frozen_stages + 1)):
            return "frozen"
        joined = "/".join(keys)
        if "/bn" in joined or "downsample_bn" in joined:
            return "backbone_norm" if trainable_bn else "frozen"
        return "backbone"
    if "sampling_offsets" in keys or "reference_points" in keys:
        return "slow"
    return "base"


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs=(10,),
                     gamma: float = 0.1) -> Callable[[int], float]:
    """mmcv StepLrUpdater: ``lr(t)``, ``base_lr`` times ``gamma`` for each
    decay epoch whose first step ``t`` has reached."""
    boundaries = {int(e * steps_per_epoch) for e in decay_epochs}

    def schedule(t):
        return base_lr * gamma ** sum(t >= b for b in boundaries)

    return schedule


def build_lr_schedule(lr_config: Mapping, base_lr: float,
                      steps_per_epoch: int,
                      max_epochs: int = 20) -> Callable[[int], float]:
    """mmcv ``lr_config`` -> ``lr(t)``, t = applied updates so far.

    Policies 'step' (gamma at each epoch of ``step``) and 'cosine'
    (``min_lr`` or ``min_lr_ratio``); warmup 'linear', 'constant' or 'exp'
    over ``warmup_iters`` with ``warmup_ratio``, by mmcv's formulas.
    """
    policy = lr_config.get("policy", "step")
    if policy == "step":
        gamma = lr_config.get("gamma", 0.1)
        step = lr_config.get("step", [10])
        if isinstance(step, int):
            step = [step]
        main = step_lr_schedule(base_lr, steps_per_epoch, step, gamma)
    elif policy in ("cosine", "CosineAnnealing"):
        min_lr = lr_config.get("min_lr")
        if min_lr is None:
            min_lr = base_lr * lr_config.get("min_lr_ratio", 0.0)
        total = max(steps_per_epoch * max_epochs, 1)

        def main(t):
            frac = min(max(t / total, 0.0), 1.0)
            return min_lr + (base_lr - min_lr) * 0.5 * (
                math.cos(math.pi * frac) + 1.0)
    else:
        raise KeyError(f"unsupported lr policy {policy!r}")

    warmup = lr_config.get("warmup")
    if not warmup:
        return main
    if warmup not in ("linear", "constant", "exp"):
        raise KeyError(f"unsupported warmup {warmup!r}")
    n = lr_config.get("warmup_iters", 500)
    ratio = lr_config.get("warmup_ratio", 0.1)

    def schedule(t):
        if t >= n:
            return main(t)
        if warmup == "linear":
            factor = 1.0 - (1.0 - t / n) * (1.0 - ratio)
        elif warmup == "constant":
            factor = ratio
        else:
            factor = ratio ** (1.0 - t / n)
        return main(t) * factor

    return schedule


def param_labels(model: nn.Module) -> Dict[str, str]:
    """``_param_label`` of every parameter, with the freezing flags read off
    the model (``frozen_stages``, ``norm_eval``, ``freeze_backbone_neck``),
    as ``tools/train.py`` reads them."""
    return {name: _param_label(name, model.frozen_stages,
                               model.freeze_backbone_neck,
                               not model.norm_eval)
            for name, _ in model.named_parameters()}


def build_optimizer(model: nn.Module, weight_decay: float = 1e-4,
                    backbone_lr_mult: float = 0.1,
                    offsets_lr_mult: float = 0.1) -> torch.optim.AdamW:
    """AdamW over the 'base', 'backbone', 'backbone_norm' (no weight decay)
    and 'slow' groups, each with its ``lr_mult``; frozen parameters are in
    no group."""
    mults = {"base": 1.0, "backbone": backbone_lr_mult,
             "backbone_norm": backbone_lr_mult, "slow": offsets_lr_mult}
    groups = {label: [] for label in mults}
    labels = param_labels(model)
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            groups[labels[name]].append(p)
    return torch.optim.AdamW(
        [dict(params=groups[k], lr_mult=m, label=k,
              weight_decay=0.0 if k == "backbone_norm" else weight_decay)
         for k, m in mults.items() if groups[k]],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """A model with its optimizer, schedule and accumulation state."""
    model: nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    grad_clip: float
    accumulate_steps: int
    generator: torch.Generator   # dropout masks
    max_gt: int                  # GT slots per image of the config
    mini_step: int = 0           # mini-batches since the last update
    updates: int = 0             # applied updates (the schedule's count)
    acc: Optional[List[torch.Tensor]] = None   # mean of the mini-batch grads
    img_norm: tuple = (IMG_NORM_MEAN, IMG_NORM_STD)   # of a uint8 feed
    ema_decay: float = 0.0
    ema: Optional[List[torch.Tensor]] = None   # EMA of the parameters

    @property
    def steps(self) -> int:
        """Mini-steps taken."""
        return self.updates * self.accumulate_steps + self.mini_step

    @property
    def lr(self) -> float:
        """The base lr of the next update."""
        return self.schedule(self.updates)

    def state_dict(self) -> dict:
        """Everything a resumed run needs to continue this one exactly."""
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    mini_step=self.mini_step, updates=self.updates,
                    acc=self.acc, ema=self.ema,
                    generator=self.generator.get_state())

    def load_state_dict(self, sd: Mapping):
        device = next(self.model.parameters()).device
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.mini_step, self.updates = sd["mini_step"], sd["updates"]
        self.acc, self.ema = ([t.to(device) for t in sd[k]]
                              if sd[k] is not None else None
                              for k in ("acc", "ema"))
        self.generator.set_state(sd["generator"])
        if dist.world_size() > 1:
            # the checkpoint holds rank 0's stream: each rank goes on from a
            # seed drawn from it, offset by its rank
            draw = torch.randint(2 ** 62, (1,), generator=self.generator,
                                 device=self.generator.device)
            self.generator.manual_seed(int(draw) + dist.rank())
            # and the ranks' summed accumulation (``gather_accumulation``),
            # which rank 0 alone goes on from
            if self.acc is not None and dist.rank():
                self.acc = [torch.zeros_like(a) for a in self.acc]

    def gather_accumulation(self):
        """Over ranks, before rank 0 saves the state (every rank calls it):
        the ranks' accumulated gradients summed onto rank 0 and zeroed
        elsewhere. The update sums them anyway, and the running mean is
        linear in them, so training goes on unchanged, while rank 0's
        checkpoint holds the whole accumulation of an update cut by the
        save."""
        if self.acc is None or dist.world_size() == 1:
            return
        dist.all_reduce_grads(self.acc)
        if dist.rank():
            for a in self.acc:
                a.zero_()


def init_trainer(config: Union[str, Mapping], device="cuda", seed: int = 0,
                 variables: Optional[Mapping] = None, impl: str = "auto",
                 steps_per_epoch: int = 20,
                 dtype: Optional[str] = None) -> TrainState:
    """Model (``variables`` or a random init from ``seed``) on ``device`` in
    train mode, with the optimizer, schedule and accumulation of the
    config's ``optimizer``, ``optimizer_config``, ``lr_config`` and
    ``runner``, the EMA of its ``custom_hooks`` and the uint8 feed's mean
    and std of its ``train_pipeline_kwargs`` (as ``tools/train.py``);
    dropout masks come from a generator seeded with ``seed``.
    ``steps_per_epoch`` (mini-batches) places the schedule's epoch
    boundaries. ``dtype`` is the activation dtype (as
    ``build_model``; ``tools/train.py --dtype``); parameters and optimizer
    state stay float32.

    Over ``torch.distributed`` ranks every rank builds the same init from
    ``seed``, and rank r's dropout generator is seeded with ``seed + r``:
    one seed on every rank would repeat the same masks on every rank's
    rows, where the JAX step draws masks over the global batch, which
    differ row by row. (The masks therefore differ from one process's on
    the same global batch; the equality checks run with dropout 0.)"""
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_model(config, seed, variables, impl,
                        dtype).to(device).train()
    opt_cfg = config.get("optimizer", {})
    hook_cfg = config.get("optimizer_config", {})
    custom = (opt_cfg.get("paramwise_cfg", {}) or {}).get("custom_keys", {})
    schedule = build_lr_schedule(
        config.get("lr_config", {}) or {}, opt_cfg.get("lr", 2e-5),
        steps_per_epoch, config.get("runner", {}).get("max_epochs", 20))
    optimizer = build_optimizer(
        model, weight_decay=opt_cfg.get("weight_decay", 1e-4),
        backbone_lr_mult=custom.get("backbone", {}).get("lr_mult", 0.1),
        offsets_lr_mult=custom.get("sampling_offsets", {}).get("lr_mult",
                                                               0.1))
    generator = torch.Generator(device=device).manual_seed(
        seed + dist.rank())
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    ema_decay = 0.0
    for hook in config.get("custom_hooks", []) or []:
        if hook.get("type", "").endswith("EMAHook"):
            ema_decay = 1.0 - hook.get("momentum", 0.0002)
    pipe = config.get("train_pipeline_kwargs", {}) or {}
    return TrainState(
        model=model, optimizer=optimizer, schedule=schedule,
        grad_clip=hook_cfg.get("grad_clip", {}).get("max_norm", 0.1),
        accumulate_steps=hook_cfg.get("cumulative_iters", 8),
        generator=generator, max_gt=config.get("max_gt", 30),
        img_norm=(tuple(pipe.get("img_norm_mean", IMG_NORM_MEAN)),
                  tuple(pipe.get("img_norm_std", IMG_NORM_STD))),
        ema_decay=ema_decay,
        ema=([p.detach().clone() for p in model.parameters()]
             if ema_decay > 0 else None))


def to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items()}


def apply_update(state: TrainState):
    """Sum the accumulated gradient over the ranks (one flat buffer; a
    no-op in one process), clip it by its global norm (all parameters) and
    take one AdamW step with the scheduled lr of each group."""
    params = list(state.model.parameters())
    dist.all_reduce_grads(state.acc)
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(a) for a in state.acc]))
    scale = torch.where(norm < state.grad_clip, torch.ones_like(norm),
                        state.grad_clip / norm)
    for p, a in zip(params, state.acc):
        p.grad = a.mul_(scale)
    lr = state.schedule(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
    state.optimizer.step()
    for p in params:
        p.grad = None
    state.acc = None
    state.updates += 1


def accumulate(state: TrainState):
    """Fold the parameters' ``.grad`` (None counts as zero) into the running
    mean and clear it; every ``accumulate_steps``-th call applies the
    update."""
    n = state.mini_step
    params = list(state.model.parameters())
    if state.acc is None:
        state.acc = [torch.zeros_like(p) for p in params]
    for p, a in zip(params, state.acc):
        a.add_(((p.grad if p.grad is not None else 0) - a) / (n + 1))
        p.grad = None
    state.mini_step = (n + 1) % state.accumulate_steps
    if state.mini_step == 0:
        apply_update(state)


def feed_keys(model: nn.Module) -> tuple:
    """The batch keys ``model`` reads: a pose model ``MODEL_KEYS``, and
    ``gt_bboxes`` where its heatmap loss takes the radius from them; SOIT
    ``DET_KEYS``, and DK-DETR ``text_feats``; InsPose ``INSPOSE_KEYS``."""
    if isinstance(model, InsPoseDetector):
        return INSPOSE_KEYS
    if isinstance(model, SOITDetector):
        return DET_KEYS + (("text_feats",) if model.cls_emb_dim else ())
    heatmap = model.head.with_heatmap and model.loss_hm_weight > 0
    return MODEL_KEYS + (("gt_bboxes",) if heatmap else ())


def model_feed(batch: Mapping, device, img_norm=(IMG_NORM_MEAN,
                                                 IMG_NORM_STD),
               keys=MODEL_KEYS) -> dict:
    """The ``keys`` of ``batch`` (those it has), on ``device``, a uint8
    image normalised there."""
    return device_prep(to_device({k: batch[k] for k in keys
                                  if k in batch}, device), img_norm)


def update_ema(state: TrainState):
    """``e = e * d + p * (1 - d)`` over every parameter."""
    if state.ema is None:
        return
    d = state.ema_decay
    with torch.no_grad():
        for e, p in zip(state.ema, state.model.parameters()):
            e.copy_(e * d + p * (1 - d))


def train_step(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    """One mini-batch: forward, backward, ``accumulate`` and the EMA.
    Returns the detached losses, over ranks summed into the global batch's
    (the same on every rank)."""
    model = state.model
    model.train()
    losses = model.forward_train(model_feed(
        batch, next(model.parameters()).device, state.img_norm,
        feed_keys(model)))
    losses["loss"].backward()
    accumulate(state)
    update_ema(state)
    return dist.all_reduce_scalars({k: v.detach()
                                    for k, v in losses.items()})
