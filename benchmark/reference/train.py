"""The train step, plain: forward and losses, backward, the running mean of
``cumulative_iters`` mini-batch gradients, then global-norm clipping and
AdamW with the recipe's parameter groups (frozen from the port's
``apis/train.py``, with AdamW written out instead of ``torch.optim``).

- the clip norm is taken over every gradient, the frozen parameters'
  included; frozen parameters get no update and no weight decay;
- weight decay on every trained parameter, decoupled (``p -= lr * wd *
  p`` before the Adam step);
- the lr is the schedule's at the count of applied updates (a 'step'
  policy only: ``lr_config.step`` epochs of ``steps_per_epoch`` updates).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn as nn

BETAS, EPS = (0.9, 0.999), 1e-8


def param_label(name: str, frozen_stages: int = 1) -> str:
    """'frozen', 'backbone', 'slow' or 'base'; the backbone's norms are
    frozen (``norm_eval``)."""
    keys = name.split(".")
    if "backbone" in keys:
        child = keys[keys.index("backbone") + 1]
        if frozen_stages >= 0 and child.startswith(("conv1", "bn1")):
            return "frozen"
        if any(child.startswith(f"layer{s}_")
               for s in range(1, frozen_stages + 1)):
            return "frozen"
        joined = "/".join(keys)
        if "/bn" in joined or "downsample_bn" in joined:
            return "frozen"
        return "backbone"
    if "sampling_offsets" in keys or "reference_points" in keys:
        return "slow"
    return "base"


class Trainer:
    """A reference model with its optimizer state, as the recipe in
    ``config`` (``optimizer``, ``optimizer_config``, ``lr_config``)."""

    def __init__(self, model: nn.Module, config: Mapping,
                 generator: torch.Generator, steps_per_epoch: int = 20):
        opt = config.get("optimizer", {})
        hook = config.get("optimizer_config", {})
        custom = (opt.get("paramwise_cfg", {}) or {}).get("custom_keys", {})
        lr_cfg = config.get("lr_config", {}) or {}
        if lr_cfg.get("policy", "step") != "step" or lr_cfg.get("warmup"):
            raise KeyError("the reference trains with a 'step' lr policy, "
                           "no warmup")
        self.model = model
        self.base_lr = opt.get("lr", 2e-5)
        self.decay_steps = [int(e * steps_per_epoch)
                            for e in lr_cfg.get("step", [10])]
        self.gamma = lr_cfg.get("gamma", 0.1)
        self.wd = opt.get("weight_decay", 1e-4)
        self.grad_clip = hook.get("grad_clip", {}).get("max_norm", 0.1)
        self.accumulate_steps = hook.get("cumulative_iters", 8)
        backbone_mult = custom.get("backbone", {}).get("lr_mult", 0.1)
        self.mult = {"base": 1.0, "backbone": backbone_mult,
                     "slow": custom.get("sampling_offsets", {}).get(
                         "lr_mult", 0.1)}
        self.names = [n for n, _ in model.named_parameters()]
        self.labels = [param_label(n, model.frozen_stages)
                       for n in self.names]
        for m in model.modules():
            if hasattr(m, "generator"):    # the dropout masks
                m.generator = generator
        self.mini_step = 0
        self.updates = 0
        self.acc: Optional[List[torch.Tensor]] = None
        self.exp_avg: Dict[int, torch.Tensor] = {}
        self.exp_avg_sq: Dict[int, torch.Tensor] = {}
        self.grad_norms: Optional[List[float]] = None

    def lr(self) -> float:
        return self.base_lr * self.gamma ** sum(self.updates >= b
                                                for b in self.decay_steps)

    @torch.no_grad()
    def apply_update(self):
        params = list(self.model.parameters())
        norm = torch.sqrt(sum((a.double() ** 2).sum() for a in self.acc))
        scale = 1.0 if norm < self.grad_clip else self.grad_clip / norm
        # the clipped gradient of every leaf, frozen ones included
        self.grad_norms = [float(torch.linalg.vector_norm(a.double())
                                 * scale) for a in self.acc]
        lr = self.lr()
        self.updates += 1
        t = self.updates
        b1, b2 = BETAS
        for i, (p, a, label) in enumerate(zip(params, self.acc,
                                              self.labels)):
            if label == "frozen":
                continue
            g = (a.double() * scale).float()
            m = self.exp_avg.setdefault(i, torch.zeros_like(p))
            v = self.exp_avg_sq.setdefault(i, torch.zeros_like(p))
            plr = lr * self.mult[label]
            p.mul_(1 - plr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            p.sub_(plr * m_hat / (v_hat.sqrt() + EPS))
        self.acc = None

    @torch.no_grad()
    def accumulate(self):
        n = self.mini_step
        params = list(self.model.parameters())
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        for p, a in zip(params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / (n + 1))
            p.grad = None
        self.mini_step = (n + 1) % self.accumulate_steps
        if self.mini_step == 0:
            self.apply_update()

    def step(self, feed: Mapping, topk_idx=None, assign=None,
             record=None) -> Dict[str, torch.Tensor]:
        """One mini-batch on a normalised feed; the hooks as the model's
        ``forward_train``."""
        self.model.train()
        losses = self.model.forward_train(feed, topk_idx, assign, record)
        losses["loss"].backward()
        self.accumulate()
        return {k: v.detach() for k, v in losses.items()}


def normalise(feed: Mapping, mean=(123.675, 116.28, 103.53),
              std=(58.395, 57.12, 57.375)) -> dict:
    """A uint8 ``(B, T, H, W, 3)`` clip as the model's float input:
    ``(x - mean) / std`` inside each sample's ``img_shape``, zero in the
    bucket padding."""
    img = feed["img"]
    dev = img.device
    x = (img.float() - torch.tensor(mean, device=dev)) / torch.tensor(
        std, device=dev)
    B, T, H, W, _ = x.shape
    h = feed["img_shape"][:, 0].view(B, 1, 1, 1, 1)
    w = feed["img_shape"][:, 1].view(B, 1, 1, 1, 1)
    inside = ((torch.arange(H, device=dev).view(1, 1, H, 1, 1) < h)
              & (torch.arange(W, device=dev).view(1, 1, 1, W, 1) < w))
    return dict(feed, img=torch.where(inside, x, torch.zeros_like(x)))
