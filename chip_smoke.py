#!/usr/bin/env python3
"""Drive the PyTorch port's clip-inference path once on one CUDA card.

    python3 chip_smoke.py

Phases (one printed line each; any failure raises and exits non-zero):

1. device: a CUDA card is required; prints nvidia-smi's name and power limit.
2. build:  compiles ``pavenet_tpu_torch/csrc/msda_fwd.cu`` with nvcc.
3. kernel: the msda kernel against its plain PyTorch version on the card at
   the three main-path shapes (encoder, pose decoder, joint decoder), value
   in f32 and bf16, plus small edge shapes (1-row, 1-column, 1x1 levels);
   times from CUDA events, median of 20 runs after warm-up.
4. serve:  ``init_detector`` on the flagship config (random weights from a
   seed) and ``inference_detector`` on 3 synthetic 3-frame 720x1280 clips
   (800x1344 bucket); checks shapes, finiteness and exactly 11 kernel
   launches per clip, and prints ms/clip.
5. parity: the same weights and batch through ``impl="torch"`` and
   ``impl="cuda"`` with TF32 off; keypoints within 1e-2 px, keep equal.

The last two lines are the kernels' JSON record and the contract line
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = "configs/videopose/pavenet_r50_frames3_posetrack17.py"
FLAGSHIP_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))  # 800x1344
EDGE_LEVELS = ((6, 9), (3, 5), (1, 3), (2, 1))
CLIPS = 3
CALLS_PER_CLIP = 11   # 6 encoder + 3 pose-decoder + 2 joint-decoder layers


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def msda_inputs(gen, B, levels, Q, H, P, D, dtype):
    import torch
    N = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.randn(B, N, H, D, device="cuda", generator=gen).to(dtype)
    loc = torch.rand(B, Q, H, L, P, 2, device="cuda", generator=gen)
    loc = loc * 1.2 - 0.1                      # some taps out of range
    attn = torch.rand(B, Q, H, L * P, device="cuda", generator=gen)
    attn = attn.softmax(-1).view(B, Q, H, L, P)
    return value, loc, attn


def check_kernel(ms_deform_attn, ms_deform_attn_torch):
    """Kernel vs plain at the main-path shapes; returns per-case records."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    N = sum(h * w for h, w in FLAGSHIP_LEVELS)
    cases = [("encoder", 3, FLAGSHIP_LEVELS, N, 8, 4, 32),
             ("pose_decoder", 3, FLAGSHIP_LEVELS, 300, 8, 15, 32),
             ("joint_decoder", 3, FLAGSHIP_LEVELS, 300, 8, 4, 32),
             ("edge_levels", 2, EDGE_LEVELS, 7, 2, 15, 4)]
    records = []
    for name, B, levels, Q, H, P, D in cases:
        for dtype, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            v, loc, attn = msda_inputs(gen, B, levels, Q, H, P, D, dtype)
            got = ms_deform_attn(v, levels, loc, attn, impl="cuda").float()
            torch.cuda.synchronize()
            want = ms_deform_attn_torch(v.float(), levels, loc, attn)
            err = (got - want).abs().max().item()
            tol = rel_tol * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"msda {name} {dtype}: max abs err "
                                     f"{err} > {tol}")
            ms = cuda_ms(lambda: ms_deform_attn(v, levels, loc, attn,
                                                impl="cuda"))
            plain_ms = cuda_ms(lambda: ms_deform_attn(v, levels, loc, attn,
                                                      impl="torch"))
            rec = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                       B=B, Q=Q, H=H, L=len(levels), P=P, D=D,
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms)
            print("kernel", json.dumps(rec), flush=True)
            records.append(rec)
    return records


def synthetic_clips(seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, 256, (720, 1280, 3), dtype=np.uint8)
             for _ in range(3)] for _ in range(CLIPS + 1)]


def check_detections(out, M=20, K=15):
    import numpy as np
    shapes = {k: out[k].shape for k in ("det_kpts", "det_bboxes", "keep")}
    if shapes != {"det_kpts": (M, K, 3), "det_bboxes": (M, 5), "keep": (M,)}:
        raise AssertionError(f"unexpected output shapes {shapes}")
    for k in ("det_kpts", "det_bboxes"):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f"{k} has non-finite values")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    sys.path.insert(0, str(ROOT))
    from pavenet_tpu_torch.apis import inference_detector, init_detector
    from pavenet_tpu_torch.apis.inference import host_batch
    from pavenet_tpu_torch.ops import _ext
    from pavenet_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                      ms_deform_attn_torch)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _ext.build("msda_fwd")
    print(f"build: {lib.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel vs plain
    records = check_kernel(ms_deform_attn, ms_deform_attn_torch)

    # 4. serve the flagship config
    model = init_detector(str(ROOT / CONFIG), device="cuda", seed=0)
    clips = synthetic_clips()
    check_detections(inference_detector(model, clips[0]))   # warm-up
    torch.cuda.synchronize()
    ms_deform_attn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [inference_detector(model, clip) for clip in clips[1:]]
    end.record()
    torch.cuda.synchronize()
    launches = ms_deform_attn.launches
    clip_ms = start.elapsed_time(end) / CLIPS
    for out in outs:
        check_detections(out)
    if launches != CALLS_PER_CLIP * CLIPS:
        raise AssertionError(f"{launches} msda kernel launches for {CLIPS} "
                             f"clips, expected {CALLS_PER_CLIP * CLIPS}")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in host_batch(clips[1], 3, (1333, 800)).items()}
    model_ms = cuda_ms(lambda: model.forward_test(batch), reps=5, warmup=1)
    print(f"serve: {CLIPS} clips at {tuple(batch['img'].shape[2:4])}, f32, "
          f"{launches} msda launches; {clip_ms:.2f} ms/clip end to end "
          f"(host pipeline included), {model_ms:.2f} ms/clip forward_test "
          f"| {smi}", flush=True)

    # 5. parity of the full model: plain msda vs the kernel, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = init_detector(str(ROOT / CONFIG), device="cuda",
                          impl="torch")
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got = model.forward_test(batch)
        want = plain.forward_test(batch)
    kpt_err = (got["det_kpts"][..., :2] - want["det_kpts"][..., :2]).abs()
    kpt_err = kpt_err.max().item()
    if not kpt_err <= 1e-2 or not torch.equal(got["keep"], want["keep"]):
        raise AssertionError(f"cuda vs torch model: det_kpts max err "
                             f"{kpt_err} px, keep equal "
                             f"{torch.equal(got['keep'], want['keep'])}")
    print(f"parity: impl=cuda vs impl=torch on the full model, TF32 off: "
          f"det_kpts max abs err {kpt_err:.3e} px, keep equal", flush=True)

    enc = next(r for r in records
               if r["case"] == "encoder" and r["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "msda_fwd", "route": "cuda",
        "source": "pavenet_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "pavenet_tpu/ops/pallas/msda_cs.py:398",
        "launches": launches, "max_abs_err": enc["max_abs_err"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "per_shape": records}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
