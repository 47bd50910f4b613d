#!/usr/bin/env python3
"""Drive the PyTorch port's clip-inference path and train step once on one
CUDA card.

    python3 chip_smoke.py

Phases (one printed line each or more; any failure raises and exits
non-zero):

1. device: a CUDA card is required; prints nvidia-smi's name and power limit.
2. build:  compiles ``csrc/msda_fwd.cu`` and ``csrc/msda_bwd.cu`` with nvcc,
   in parallel, and prints each build time.
3. kernel: the msda forward kernel against its plain PyTorch version at the
   main-path shapes (encoder, pose decoder, serving joint decoder Q=300,
   train joint decoder Q=450), value in f32 and bf16, plus edge levels
   (1-row, 1-column, 1x1); times from CUDA events, median of 20.
4. backward: the msda backward kernel against autograd of the plain version
   at the encoder, pose decoder and train joint decoder shapes and the edge
   levels, f32 and bf16; backward times of both.
5. serve:  ``init_detector`` on the flagship config (random weights from a
   seed) and ``inference_detector`` on 3 synthetic 720x1280 clips (800x1344
   bucket): shapes, finiteness, exactly 11 forward launches per clip.
6. parity: the same weights and batch through ``impl="torch"`` and
   ``impl="cuda"`` with TF32 off; keypoints within 1e-2 px, keep equal.
7. train:  ``init_trainer`` on the flagship config, 8 mini-steps of
   ``dummy_clip_batch(train=True)`` at 800x1344, B=1, 30 GT slots, which is
   one applied update (``cumulative_iters=8``): finite losses, exactly 11
   forward and 11 backward launches per mini-step, frozen parameters
   unchanged, every other parameter with a gradient changed; ms/step, the
   host share spent in matching and the peak memory.
8. train parity: one mini-step's matching, losses and gradient norm with
   ``impl="cuda"`` and with ``impl="torch"`` (same weights and batch,
   dropout 0, TF32 off).

The last two lines are the kernels' JSON record and the contract line
``{"ok": true, "device": {...}}``.
"""
import json
import statistics
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
TRAIN_STEPS = 8       # = cumulative_iters of the flagship config
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 flop/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# flops per in-range tap and channel, corner weights counted once per tap:
# forward 4 corner FMAs + the weighted sum; backward the bilinear value,
# its x and y derivatives, three dot products and four scaled atomics
FWD_FLOPS, BWD_FLOPS = 10, 34


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
    return statistics.median(times)


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


def pixel_coords(loc, levels):
    """Sampling coordinates ``loc * (W, H) - 0.5`` per level, (..., L, P)."""
    import torch
    wh = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32,
                      device=loc.device)
    xy = loc * wh[:, None, :] - 0.5
    return xy[..., 0], xy[..., 1], wh


def msda_bound(backward, value, levels, loc):
    """Least time of one call on an H100: each input read once and each
    output written once over the HBM rate, against the flops of the taps
    that lie in range (this run's data) over the f32 rate."""
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    x, y, wh = pixel_coords(loc, levels)
    taps = ((x > -1) & (y > -1) & (x < wh[:, 0, None])
            & (y < wh[:, 1, None])).sum().item()
    vb = value.element_size()
    value_bytes = B * N * H * D * vb
    loc_attn_bytes = B * Q * H * L * P * 3 * 4
    if backward:   # + g (f32) in; grad_value, grad_loc, grad_attn out
        nbytes = 2 * value_bytes + 2 * loc_attn_bytes + B * Q * H * D * 4
        flops = taps * D * BWD_FLOPS
    else:          # + out
        nbytes = value_bytes + loc_attn_bytes + B * Q * H * D * vb
        flops = taps * D * FWD_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_cases():
    N = sum(h * w for h, w in FLAGSHIP_LEVELS)
    return [("encoder", 3, FLAGSHIP_LEVELS, N, 8, 4, 32),
            ("pose_decoder", 3, FLAGSHIP_LEVELS, 300, 8, 15, 32),
            ("joint_decoder", 3, FLAGSHIP_LEVELS, 300, 8, 4, 32),
            ("joint_decoder_train", 3, FLAGSHIP_LEVELS, 450, 8, 4, 32),
            ("edge_levels", 2, EDGE_LEVELS, 7, 2, 15, 4)]


def check_forward(ms_deform_attn, ms_deform_attn_torch):
    """Forward kernel vs plain; returns per-case records."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for name, B, levels, Q, H, P, D in kernel_cases():
        for dtype, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            v, loc, attn = msda_inputs(gen, B, levels, Q, H, P, D, dtype)
            got = ms_deform_attn(v, levels, loc, attn, impl="cuda").float()
            torch.cuda.synchronize()
            want = ms_deform_attn_torch(v.float(), levels, loc, attn)
            err = (got - want).abs().max().item()
            tol = rel_tol * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"msda fwd {name} {dtype}: max abs err "
                                     f"{err} > {tol}")
            ms = cuda_ms(lambda: ms_deform_attn(v, levels, loc, attn,
                                                impl="cuda"))
            plain_ms = cuda_ms(lambda: ms_deform_attn(v, levels, loc, attn,
                                                      impl="torch"))
            bound_ms, bound_by = msda_bound(False, v, levels, loc)
            rec = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                       B=B, Q=Q, H=H, L=len(levels), P=P, D=D,
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            print("kernel fwd", json.dumps(rec), flush=True)
            records.append(rec)
    return records


def check_backward(ext, ms_deform_attn_torch):
    """Backward kernel vs autograd of the plain version; grad_loc is compared
    away from pixel boundaries (within 1e-3 px of an integer coordinate the
    derivative jumps, and the two versions round the coordinate
    differently). Returns per-case records."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for name, B, levels, Q, H, P, D in kernel_cases():
        if name == "joint_decoder":       # serving only: no backward
            continue
        L = len(levels)
        starts = [0]
        for h, w in levels[:-1]:
            starts.append(starts[-1] + h * w)
        shapes = torch.tensor(levels, dtype=torch.int32, device="cuda")
        level_start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            v, loc, attn = msda_inputs(gen, B, levels, Q, H, P, D, dtype)
            g = torch.randn(B, Q, H * D, device="cuda", generator=gen)
            got = ext.msda_bwd(v, shapes, level_start, loc, attn, g)
            torch.cuda.synchronize()
            inputs = [t.float().requires_grad_() for t in (v, loc, attn)]
            out = ms_deform_attn_torch(inputs[0], levels, *inputs[1:])
            want = torch.autograd.grad(out, inputs, g, retain_graph=True)
            x, y, _ = pixel_coords(loc, levels)
            smooth = (((x - x.round()).abs() > 1e-3)
                      & ((y - y.round()).abs() > 1e-3))[..., None]
            errs = {}
            for k, a, b in zip(("value", "loc", "attn"), got, want):
                diff = (a.float() - b).abs()
                if k == "loc":
                    diff = diff * smooth
                tol = rel_tol * b.abs().max().item()
                errs[k] = diff.max().item()
                if not errs[k] <= tol:
                    raise AssertionError(f"msda bwd {name} {dtype} grad_{k}:"
                                         f" max abs err {errs[k]} > {tol}")
            ms = cuda_ms(lambda: ext.msda_bwd(v, shapes, level_start, loc,
                                              attn, g))
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                out, inputs, g, retain_graph=True))
            bound_ms, bound_by = msda_bound(True, v, levels, loc)
            rec = dict(case=name, dtype=str(dtype).replace("torch.", ""),
                       B=B, Q=Q, H=H, L=L, P=P, D=D,
                       max_abs_err=max(errs.values()),
                       errs=errs, rel_tol=rel_tol, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       loc_taps_near_boundary=int((~smooth).sum().item()))
            print("kernel bwd", json.dumps(rec), flush=True)
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


def serve(smi):
    """Phases 5 and 6; returns the serving run's forward launches."""
    import torch
    from pavenet_tpu_torch.apis import inference_detector, init_detector
    from pavenet_tpu_torch.apis.inference import host_batch
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    model = init_detector(str(ROOT / CONFIG), device="cuda", seed=0)
    clips = synthetic_clips()
    check_detections(inference_detector(model, clips[0]))   # warm-up
    torch.cuda.synchronize()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [inference_detector(model, clip) for clip in clips[1:]]
    end.record()
    torch.cuda.synchronize()
    launches = ms_deform_attn.launches
    bwd_launches = ms_deform_attn.backward_launches
    clip_ms = start.elapsed_time(end) / CLIPS
    for out in outs:
        check_detections(out)
    if (launches, bwd_launches) != (CALLS_PER_CLIP * CLIPS, 0):
        raise AssertionError(f"{launches} msda forward and {bwd_launches} "
                             f"backward launches for {CLIPS} clips, expected "
                             f"{CALLS_PER_CLIP * CLIPS} and 0")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in host_batch(clips[1], 3, (1333, 800)).items()}
    model_ms = cuda_ms(lambda: model.forward_test(batch), reps=5, warmup=1)
    print(f"serve: {CLIPS} clips at {tuple(batch['img'].shape[2:4])}, f32, "
          f"{launches} msda launches; {clip_ms:.2f} ms/clip end to end "
          f"(host pipeline included), {model_ms:.2f} ms/clip forward_test "
          f"| {smi}", flush=True)

    # full-model parity: plain msda vs the kernel, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = init_detector(str(ROOT / CONFIG), device="cuda", impl="torch")
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
    torch.backends.cudnn.allow_tf32 = True
    return launches


def train(smi):
    """Phase 7; returns the trainer state and the train run's launches."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis import init_trainer, train_step
    from pavenet_tpu_torch.apis.train import _param_label
    from pavenet_tpu_torch.core.assigner import hungarian_assign
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    state = init_trainer(str(ROOT / CONFIG), device="cuda", seed=0)
    if state.accumulate_steps != TRAIN_STEPS:
        raise AssertionError(f"cumulative_iters {state.accumulate_steps}")
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(0)
    batches = [dummy_clip_batch(rng, max_gt=state.max_gt, train=True)
               for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_deform_attn.launches = ms_deform_attn.backward_launches = 0
    hungarian_assign.seconds = 0.0
    step_ms, wall_s, grads_seen = [], [], None
    for i, batch in enumerate(batches):
        if i == TRAIN_STEPS - 1:
            # parameters whose clipped mean gradient so far is well above
            # Adam's eps: the update must move them
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(a) for a in state.acc])).item()
            scale = min(1.0, state.grad_clip / norm)
            grads_seen = {n for (n, _), a in zip(model.named_parameters(),
                                                  state.acc)
                          if a.abs().max().item() * scale > 1e-5}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.perf_counter() - t0)
        step_ms.append(start.elapsed_time(end))
        bad = {k: v.item() for k, v in losses.items()
               if not torch.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {i}: {bad}")
    launches = (ms_deform_attn.launches, ms_deform_attn.backward_launches)
    match_s = hungarian_assign.seconds
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = (CALLS_PER_CLIP * TRAIN_STEPS,) * 2
    if launches != expected:
        raise AssertionError(f"{launches} msda (forward, backward) launches "
                             f"in {TRAIN_STEPS} mini-steps, expected "
                             f"{expected}")
    if (state.updates, state.mini_step) != (1, 0):
        raise AssertionError(f"{state.updates} updates, mini-step "
                             f"{state.mini_step}: expected one update")
    frozen_moved, stuck = [], []
    for n, p in model.named_parameters():
        moved = not torch.equal(before[n], p.detach())
        if _param_label(n, model.frozen_stages) == "frozen":
            if moved:
                frozen_moved.append(n)
        elif n in grads_seen and not moved:
            stuck.append(n)
    if frozen_moved or stuck:
        raise AssertionError(f"frozen parameters changed: {frozen_moved}; "
                             f"parameters with a gradient unchanged: {stuck}")
    n_frozen = sum(_param_label(n, model.frozen_stages) == "frozen"
                   for n in before)
    print("train losses (last mini-step): "
          + json.dumps({k: round(v.item(), 5) for k, v in losses.items()}),
          flush=True)
    print(f"train: {TRAIN_STEPS} mini-steps at 800x1344, B=1, f32, "
          f"{state.max_gt} GT slots, one applied update; msda launches "
          f"{launches[0]} forward, {launches[1]} backward "
          f"({CALLS_PER_CLIP}+{CALLS_PER_CLIP} per mini-step); "
          f"{statistics.median(step_ms[1:]):.2f} ms/step (median of steps "
          f"2-{TRAIN_STEPS}, CUDA events; {min(step_ms[1:]):.2f}-"
          f"{max(step_ms[1:]):.2f}); matching on the host "
          f"{match_s * 1e3 / TRAIN_STEPS:.2f} ms/step = "
          f"{100 * match_s / sum(wall_s):.2f}% of the wall time; peak "
          f"memory {peak_gb:.2f} GiB; {n_frozen} frozen tensors unchanged, "
          f"all {len(grads_seen)} of {len(before) - n_frozen} trained tensors "
          f"with a clipped gradient above 1e-5 changed | {smi}",
          flush=True)
    return state, launches


def train_parity(state):
    """Phase 8: impl=cuda vs impl=torch on one mini-step, dropout 0 (eval
    mode), TF32 off."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.apis.train import to_device
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_model = state.model.eval()
    plain = build_model(str(ROOT / CONFIG), impl="torch").cuda().eval()
    plain.load_state_dict(cuda_model.state_dict())
    batch = to_device(dummy_clip_batch(np.random.RandomState(1),
                                       max_gt=state.max_gt, train=True),
                      "cuda")
    results = []
    for model in (cuda_model, plain):
        with torch.no_grad():
            targets = model.match(model.forward_outputs(
                batch["img"], batch["img_shape"]), batch)
        model.zero_grad(set_to_none=True)
        losses = model.forward_train(batch)
        losses["loss"].backward()
        norm = torch.linalg.vector_norm(torch.stack([
            p.grad.norm() for p in model.parameters() if p.grad is not None]))
        results.append(([t.query_idx for t in targets],
                        {k: v.item() for k, v in losses.items()},
                        norm.item()))
        model.zero_grad(set_to_none=True)
    (idx_c, loss_c, norm_c), (idx_t, loss_t, norm_t) = results
    if not all(torch.equal(a, b) for a, b in zip(idx_c, idx_t)):
        raise AssertionError("cuda and torch train steps matched different "
                             "queries")
    rel = {k: abs(loss_c[k] - loss_t[k]) / abs(loss_t[k]) for k in loss_t}
    bad = {k: r for k, r in rel.items() if not r <= 1e-4}
    norm_rel = abs(norm_c - norm_t) / norm_t
    if bad or not norm_rel <= 1e-3:
        raise AssertionError(f"cuda vs torch train step: loss rel errors "
                             f"{bad}, grad norm {norm_c} vs {norm_t}")
    print(f"train parity: impl=cuda vs impl=torch, one mini-step, dropout 0, "
          f"TF32 off: matched queries equal in {len(idx_c)} sets, max loss "
          f"rel err {max(rel.values()):.3e}, grad norm {norm_c:.6g} vs "
          f"{norm_t:.6g} (rel {norm_rel:.3e})", flush=True)
    torch.backends.cudnn.allow_tf32 = True


def kernel_record(name, records, launches, replaces, **extra):
    enc = next(r for r in records
               if r["case"] == "encoder" and r["dtype"] == "float32")
    return {"name": name, "route": "cuda",
            "source": f"pavenet_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": enc["max_abs_err"], "ms": enc["ms"],
            "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
            "bound_by": enc["bound_by"], "library_ms": None, **extra,
            "per_shape": records}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    sys.path.insert(0, str(ROOT))
    from pavenet_tpu_torch.ops import _ext
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build (both kernels at once)
    for name, seconds in _ext.build_all().items():
        print(f"build: csrc/{name}.cu in {seconds:.2f} s", flush=True)

    # 3-4. kernels vs plain
    fwd = check_forward(ms_deform_attn, ms_deform_attn_torch)
    bwd = check_backward(_ext, ms_deform_attn_torch)

    # 5-6. serve
    serve_launches = serve(smi)

    # 7-8. train
    state, (fwd_launches, bwd_launches) = train(smi)
    train_parity(state)

    print(json.dumps({"kernels": [
        kernel_record("msda_fwd", fwd, fwd_launches,
                      "pavenet_tpu/ops/pallas/msda_cs.py:398",
                      serve_launches=serve_launches),
        kernel_record("msda_bwd", bwd, bwd_launches,
                      "pavenet_tpu/ops/pallas/msda_cs.py:662"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
