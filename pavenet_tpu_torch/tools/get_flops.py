"""Model complexity: parameter counts and the forward FLOPs of one
``forward_test`` (as ``tools/get_flops.py`` of the JAX package).

    python -m pavenet_tpu_torch.tools.get_flops <config.py> [--shape H W]
        [--batch-size 1] [--device cuda|cpu] [--cfg-options k=v ...]

The parameters are counted on a build on the ``meta`` device (no weights
made), as the JAX CLI counts its inference init's ``params`` plus
``batch_stats``: the BatchNorm running statistics count, the constants the
JAX package keeps outside its variables (Swin's relative index, the flows'
masks, the OKS sigmas) do not, nor do the subtrees a JAX init makes only
in train mode (the RealNVP flows and PETR's heatmap branch, printed apart).
The breakdown is by top-level module under the JAX tree's names, of the
parameters alone.

The FLOPs are the port's own, of one ``forward_test`` on a seeded batch
(pose models: ``dummy_clip_batch``; SOIT, DK-DETR with seeded text
features, and InsPose: one image): ``torch.utils.flop_counter`` counts the
torch operations, and the msda and window-attention calls, which run
through the hand-written kernels where the counter cannot see them, are
counted from each call's shapes (``ops/flops.py``: every tap and window) on
lines of their own, SOIT's and DK-DETR's dynamic-mask msda call among them.
They are not compared with XLA's cost analysis.
``main(argv)`` returns the counts.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Model params/FLOPs report")
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs=2, default=[800, 1344],
                   metavar=("H", "W"), help="input bucket (default 800 1344, "
                   "the eval bucket)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or "
                   "'cpu'")
    p.add_argument("--cfg-options", nargs="+", default=[])
    return p.parse_args(argv)


def human(n: float, unit: str = "") -> str:
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= div:
            return f"{n / div:.3f} {suf}{unit}"
    return f"{n:.0f} {unit}"


def count_params(model) -> dict:
    """The JAX inference init's variable counts of ``model``'s config:
    ``total`` (parameters and BatchNorm statistics), ``modules`` (the
    parameters by top-level name) and ``train_only`` (what the JAX init
    makes only in train mode, not in ``total``)."""
    from pavenet_tpu_torch.utils.weight_convert import STATS, TRAIN_ONLY
    total = train_only = 0
    modules = {}
    for key, t in model.state_dict().items():
        path = key.split(".")
        if any(p in TRAIN_ONLY for p in path):
            train_only += t.numel()
            continue
        total += t.numel()
        if path[-1] not in STATS.values():
            modules[path[0]] = modules.get(path[0], 0) + t.numel()
    return dict(total=total, modules=dict(sorted(modules.items())),
                train_only=train_only)


def flops_batch(model, H: int, W: int, batch_size: int = 1) -> dict:
    """The JAX CLI's seeded batch (``RandomState(0)``): a pose model's clip
    of ``dummy_clip_batch``, else one image, and DK-DETR's text features."""
    import numpy as np
    from pavenet_tpu_torch.models import InsPoseDetector, SOITDetector
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch
    rng = np.random.RandomState(0)
    if not isinstance(model, (SOITDetector, InsPoseDetector)):
        return dummy_clip_batch(
            rng, batch_size=batch_size, num_frames=model.num_frames,
            height=H, width=W, num_keypoints=model.num_keypoints)
    batch = dict(
        img=rng.randn(batch_size, H, W, 3).astype(np.float32),
        img_shape=np.tile(np.array([[H, W - 11]], np.int32),
                          (batch_size, 1)),
        scale_factor=np.full((batch_size, 2), 1.0, np.float32))
    if getattr(model, "cls_emb_dim", 0):
        batch["text_feats"] = rng.randn(
            model.num_classes, model.cls_emb_dim).astype(np.float32)
    return batch


def forward_flops(model, batch) -> dict:
    """FLOPs of one ``model.forward_test(batch)``: ``torch`` from the torch
    counter, ``msda`` and ``window_attn`` (with their call counts) from
    the calls' shapes, and ``total``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from pavenet_tpu_torch.ops.flops import kernel_flops
    with torch.inference_mode(), kernel_flops() as kernels, \
            FlopCounterMode(display=False) as counter:
        model.forward_test(batch)
    if batch["img"].is_cuda:
        torch.cuda.synchronize(batch["img"].device)
    out = dict(torch=counter.get_total_flops(), **kernels)
    out["total"] = out["torch"] + out["msda"] + out["window_attn"]
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.models.builder import build_detector
    from pavenet_tpu_torch.tools.train import load_config

    if str(args.device).startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to count on the CPU)")
    t0 = time.perf_counter()
    cfg = load_config(args.config, args.cfg_options)
    with torch.device("meta"):
        counts = count_params(build_detector(cfg.model))
    total = counts["total"]
    # no parameter asks for a gradient: the counter's module tracker hooks
    # the autograd graph of any module input that does
    model = build_model(cfg, seed=0).to(args.device).eval().requires_grad_(
        False)
    H, W = args.shape
    batch = {k: torch.as_tensor(v, device=args.device)
             for k, v in flops_batch(model, H, W, args.batch_size).items()}
    flops = forward_flops(model, batch)

    print(f"config: {args.config}")
    print(f"input:  {tuple(batch['img'].shape)}")
    print(f"params: {total:,} ({human(total)})")
    for name, n in counts["modules"].items():
        print(f"  {name:<28s} {n:>12,} ({100.0 * n / total:5.1f}%)")
    if counts["train_only"]:
        print(f"train-only, not counted: {counts['train_only']:,} "
              f"({human(counts['train_only'])})")
    print(f"forward FLOPs (torch counter):    {human(flops['torch'], 'FLOP')}")
    print(f"msda, {flops['msda_calls']} calls (from shapes): "
          f"{human(flops['msda'], 'FLOP')}")
    if flops["window_attn_calls"]:
        print(f"window attention, {flops['window_attn_calls']} calls (from "
              f"shapes): {human(flops['window_attn'], 'FLOP')}")
    print(f"forward FLOPs in all:             {human(flops['total'], 'FLOP')}")
    return dict(params=total, modules=counts["modules"],
                train_only=counts["train_only"], flops=flops,
                input=tuple(batch["img"].shape),
                seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
