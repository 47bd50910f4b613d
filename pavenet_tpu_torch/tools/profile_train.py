"""Where a config's train step spends its time on one CUDA card.

    python -m pavenet_tpu_torch.tools.profile_train [--config CFG]
        [--steps 8] [--out DIR]

The flagship config unless ``--config`` names another (the Swin-L and T=5
configs take the same batch). Random weights from seed 0,
``dummy_clip_batch(train=True)`` at 800x1344, B=1, the config's frames,
f32 (TF32 as PyTorch defaults it: convolutions yes, matmuls no). Two
warm-up mini-steps, ``--steps`` timed mini-steps (host clock to a
synchronise), then ``--steps`` mini-steps under ``torch.profiler``; with
the default 8 (the config's ``cumulative_iters``) each window holds one
applied update, so its optimizer time counts once per 8 mini-steps. Prints
the wall time per mini-step with and without the profiler, the device busy
time and its idle share against both, the host's matching time, and the
device time by kernel kind; the full kernel table goes to
``DIR/profile_train.txt``.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs/videopose/pavenet_r50_frames3_posetrack17.py"
# first match wins
KINDS = (
    ("msda forward kernel", r"msda_fwd_kernel"),
    ("msda backward kernel", r"msda_bwd_kernel"),
    ("convolution (cuDNN)", r"conv|cudnn|implicit|dgrad|wgrad|fprop"),
    ("GEMM", r"gemm|cutlass|cublas|nvjet|xmma"),
    ("LayerNorm / GroupNorm", r"layer_norm|group_norm|GroupNorm|LayerNorm"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce"),
    ("copy / cat / gather / index", r"copy|Memcpy|Memset|cat|gather|index|"
                                    r"scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def main():
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pavenet_tpu_torch.apis import init_trainer, train_step
    from pavenet_tpu_torch.core.assigner import hungarian_assign
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=str(CONFIG))
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    state = init_trainer(args.config, device="cuda", seed=0)
    rng = np.random.RandomState(0)
    batches = [dummy_clip_batch(rng, num_frames=state.model.num_frames,
                                max_gt=state.max_gt, train=True)
               for _ in range(2 + 2 * args.steps)]
    for batch in batches[:2]:
        train_step(state, batch)

    def run(steps):
        torch.cuda.synchronize()
        hungarian_assign.seconds = 0.0
        t0 = time.perf_counter()
        for batch in steps:
            train_step(state, batch)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / len(steps),
                hungarian_assign.seconds * 1e3 / len(steps))

    plain_ms, plain_match_ms = run(batches[2:2 + args.steps])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, match_ms = run(batches[2 + args.steps:])

    by_kind, by_name = defaultdict(float), defaultdict(float)
    for e in prof.events():
        # device kernels and copies; not the device-side ranges of
        # record_function annotations, which span other kernels
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us = e.time_range.elapsed_us()
            by_kind[kind_of(e.name)] += us / 1e3 / args.steps
            by_name[e.name] += us / 1e3 / args.steps
    busy = sum(by_kind.values())
    print(f"train step, {Path(args.config).name} 800x1344 B=1 f32, "
          f"{args.steps} timed and {args.steps} profiled mini-steps | {smi}")
    print(f"wall {plain_ms:.2f} ms/step unprofiled ({plain_match_ms:.2f} "
          f"ms/step host matching), {wall_ms:.2f} ms/step profiled "
          f"({match_ms:.2f}); device busy {busy:.2f} ms/step: idle "
          f"{100 * (1 - busy / plain_ms):.1f}% of the unprofiled wall time, "
          f"{100 * (1 - busy / wall_ms):.1f}% of the profiled one")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:<28} {ms:9.2f} ms/step {100 * ms / busy:6.1f}%")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"profile_train_{Path(args.config).stem}.txt",
              "w") as f:
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
            f.write(f"{ms:10.3f} ms/step  {kind_of(name):<28} {name}\n")


if __name__ == "__main__":
    main()
