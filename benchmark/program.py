"""The system under test: the port's model and train state, built on the
device from a configuration file and given the seed's weights
(``seed_weights``: one draw, loaded into the program and, after the
window, into the reference). Besides this module only the drivers
(``serve.py``, ``train.py``) and ``run.py`` (the kernels' build) import
``pavenet_tpu_torch``."""
from __future__ import annotations

from typing import Mapping

import torch

from .weights import make_state_dict, shapes_of


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device):
    if is_cuda(device):
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if is_cuda(device) else 0


def reset_peak(device):
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    """Hand the freed blocks back, so that what runs next (the reference)
    finds the memory the program held."""
    import gc
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def weight_seed(seed: int) -> int:
    return int(seed) * 4


def dropout_seed(seed: int) -> int:
    return int(seed) * 4 + 3


def set_math(config: Mapping):
    """The precision the configuration states for float32 products:
    ``math.matmul_tf32`` and ``math.cudnn_tf32``."""
    torch.backends.cuda.matmul.allow_tf32 = config["math"]["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = config["math"]["cudnn_tf32"]


def seed_weights(config: Mapping, seed: int, device) -> dict:
    """The seed's weights, one draw on ``device`` (``weights.py``), keyed
    by the frozen reference's state dict: its names, shapes and order,
    which no change to the port moves. The same dict loads into the
    program and into the reference."""
    from .reference.models.builder import build_detector
    with torch.device("meta"):
        ref = build_detector(config["config"]["model"])
    return make_state_dict(shapes_of(ref), weight_seed(seed), device)


def on_host(weights: Mapping) -> dict:
    """A host copy of ``weights``, kept through the window for the
    reference."""
    return {k: v.cpu() for k, v in weights.items()}


def load_weights(model: torch.nn.Module, weights: Mapping):
    """``weights`` into ``model``, every floating entry of its state dict
    and no other; the integer entries (counters) keep the model's."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    bad = [k for k in missing
           if model.state_dict()[k].dtype.is_floating_point] + unexpected
    if bad:
        raise KeyError(f"weights do not fit the model: {bad[:5]}")
    return model


def build_model(config: Mapping, weights: Mapping,
                device) -> torch.nn.Module:
    """The port's detector for ``config['config']``, made on ``device`` (no
    host-side init) with ``weights``."""
    from pavenet_tpu_torch.config import resolve_act_dtype
    from pavenet_tpu_torch.models.builder import build_detector
    cfg = config["config"]
    with torch.device(device):
        model = build_detector(cfg["model"], dtype=resolve_act_dtype(cfg))
    # a buffer made from numpy in a constructor stays on the host
    return load_weights(model.to(device), weights)


def img_norm(config: Mapping):
    from pavenet_tpu_torch.apis.prep import IMG_NORM_MEAN, IMG_NORM_STD
    pipe = config["config"].get("train_pipeline_kwargs") or {}
    return (tuple(pipe.get("img_norm_mean", IMG_NORM_MEAN)),
            tuple(pipe.get("img_norm_std", IMG_NORM_STD)))


def train_state(config: Mapping, weights: Mapping, seed: int, device):
    """The port's ``TrainState`` as ``apis.train.init_trainer`` assembles
    it, around ``build_model``'s model: the recipe's optimizer groups,
    schedule, clip and accumulation, dropout masks from a generator on the
    device (seeded from ``seed``), the EMA where the recipe has an
    ``EMAHook``.

    A copy of ``init_trainer``'s assembly, because ``init_trainer`` builds
    and initialises the model on the host (``apis.inference.build_model``)
    before its move to the card: for Swin-L 221M parameters drawn on the
    CPU and copied, which every run's set-up would pay for weights that
    the seed's then replace. It has to follow ``init_trainer``:
    ``benchmark/tests/test_bench_reference.py::
    test_train_state_follows_init_trainer`` compares the two."""
    from pavenet_tpu_torch.apis.train import (TrainState, build_lr_schedule,
                                              build_optimizer)
    from pavenet_tpu_torch.models.layers.transformer import Dropout
    cfg = config["config"]
    model = build_model(config, weights, device).train()
    opt_cfg = cfg.get("optimizer", {})
    hook_cfg = cfg.get("optimizer_config", {})
    custom = (opt_cfg.get("paramwise_cfg", {}) or {}).get("custom_keys", {})
    schedule = build_lr_schedule(
        cfg.get("lr_config", {}) or {}, opt_cfg.get("lr", 2e-5),
        config["steps_per_epoch"], cfg.get("runner", {}).get("max_epochs",
                                                             20))
    optimizer = build_optimizer(
        model, weight_decay=opt_cfg.get("weight_decay", 1e-4),
        backbone_lr_mult=custom.get("backbone", {}).get("lr_mult", 0.1),
        offsets_lr_mult=custom.get("sampling_offsets", {}).get("lr_mult",
                                                               0.1))
    generator = torch.Generator(device=device).manual_seed(
        dropout_seed(seed))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    ema_decay = 0.0
    for hook in cfg.get("custom_hooks", []) or []:
        if hook.get("type", "").endswith("EMAHook"):
            ema_decay = 1.0 - hook.get("momentum", 0.0002)
    return TrainState(
        model=model, optimizer=optimizer, schedule=schedule,
        grad_clip=hook_cfg.get("grad_clip", {}).get("max_norm", 0.1),
        accumulate_steps=hook_cfg.get("cumulative_iters", 8),
        generator=generator, max_gt=cfg.get("max_gt", 30),
        img_norm=img_norm(config), ema_decay=ema_decay,
        ema=([p.detach().clone() for p in model.parameters()]
             if ema_decay > 0 else None))


def reference_model(config: Mapping, weights: Mapping, device):
    """The benchmark's plain reference of the same configuration, with
    ``weights``."""
    from .reference.models.builder import build_detector
    with torch.device(device):
        model = build_detector(config["config"]["model"])
    return load_weights(model.to(device), weights)
