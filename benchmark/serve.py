"""Serving cells: a closed loop of ``clients`` = 1 over a pool of clips.

A request copies its uint8 clip to the card, normalises it there
(``apis.train.model_feed`` -> ``apis.prep.device_prep``), runs
``VideoPoseDetector.forward_test`` and copies the detections to the host.
Its latency runs from its issue to its detections on the host.

The traced run measures the same window untraced first (``mfu.serve`` and
the rate the profiler's overhead is taken against), then a few requests
with a span that synchronises after the prep (``prep_ms.serve``), then a
few under ``torch.profiler`` (the device metrics).
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from . import check, program
from . import devtrace
from .cost.model import clip_cost
from .cost.msda import bound_s
from .cost.peaks import FLOPS
from .harness import log, machine_drift, machine_state

KEYS = ("img", "img_shape", "scale_factor")
SPAN_REQUESTS, TRACE_REQUESTS = 20, 10


def p95(values):
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run(cell, args, t0: float, device) -> dict:
    from pavenet_tpu_torch.apis.train import model_feed
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn as msda
    from . import traffic as gen

    mix, config = cell.traffic, cell.config
    if mix["clients"] != 1:
        raise ValueError("the serving driver runs one client")
    program.set_math(config)
    weights = program.seed_weights(config, args.seed, device)
    model = program.build_model(config, weights, device).eval()
    weights = program.on_host(weights)
    pool = gen.serve_pool(mix, args.seed, model.num_frames, device)
    norm = program.img_norm(config)
    topk = {}
    current = [None]
    hook = model.head.register_forward_hook(
        lambda m, i, o: topk.__setitem__(current[0], o["topk_idx"]))

    def request(i, span=None):
        current[0] = i
        clip = pool[i % len(pool)]
        t = time.perf_counter()
        feed = model_feed(clip, device, norm, KEYS)
        if span is not None:
            program.sync(device)
            span.append(time.perf_counter() - t)
        with torch.inference_mode():
            out = model.forward_test(feed)
        return {k: v.cpu() for k, v in out.items()}

    for i in range(3):                  # every shape of the loop, warmed
        request(-1 - i)
    program.sync(device)
    setup_s = time.perf_counter() - t0
    setup_peak = program.peak(device)
    program.reset_peak(device)
    machine0 = machine_state()

    outs, lat = [], []
    launches0 = msda.launches
    start = time.perf_counter()
    while True:
        issued = time.perf_counter()
        outs.append(request(len(outs)))
        done = time.perf_counter()
        lat.append(done - issued)
        if done - start >= args.seconds:
            break
    window_s = done - start
    log("machine over the window: "
        + machine_drift(machine0, machine_state()))
    n = len(outs)
    launches = (msda.launches - launches0) / n
    window_peak = program.peak(device)
    e2e = dict(clips_per_s=n * mix["clips_per_request"] / window_s,
               clip_latency_p95_ms=p95(lat) * 1e3,
               peak_mem_gib=window_peak / 2 ** 30,
               setup_s=setup_s)
    log(f"window: {n} requests in {window_s:.3f} s, latency median "
        f"{statistics.median(lat) * 1e3:.3f} ms, p95 "
        f"{e2e['clip_latency_p95_ms']:.3f} ms over {n} samples; "
        f"{launches:g} msda launches a request")

    run_info = None
    if args.trace:
        spans = []
        for i in range(SPAN_REQUESTS):
            request(n + i, spans)
        base = n + SPAN_REQUESTS
        traced = devtrace.trace(
            lambda: [request(base + i) for i in range(TRACE_REQUESTS)],
            lambda: [request(base + TRACE_REQUESTS + i)
                     for i in range(TRACE_REQUESTS)])
        clips = TRACE_REQUESTS * mix["clips_per_request"]
        cost = clip_cost(config["config"]["model"], mix["height"],
                         mix["width"], mix["img_shape"], train=False,
                         batch=mix["clips_per_request"])
        log(f"traced rate {clips / traced['window_s']:.4f} clips/s against "
            f"{e2e['clips_per_s']:.4f} untraced")
        run_info = dict(
            kind="serve", clips_per_s=e2e["clips_per_s"],
            flops_per_clip=cost["flops"] / mix["clips_per_request"],
            peak_flops=FLOPS[config["peak"]],
            prep_s_per_clip=statistics.mean(spans)
            / mix["clips_per_request"],
            trace=traced, trace_clips=clips,
            msda_fwd_bound_s_per_clip=sum(
                bound_s(v, loc) for v, loc in cost["msda_calls"])
            / mix["clips_per_request"])
    hook.remove()

    # the check: a sample of the served requests drawn from the seed, one
    # per clip of the pool it covers, and the slowest request
    rng = np.random.default_rng(args.seed)
    by_clip = {}
    for i in rng.permutation(n):
        by_clip.setdefault(int(i) % len(pool), int(i))
    sample = sorted(by_clip.values())[:mix["check_requests"] - 1]
    sample = sorted(set(sample) | {int(np.argmax(lat))})
    kept = {i: (outs[i], topk[i].cpu()) for i in sample}
    del model, outs, topk
    program.free(device)
    numbers = judge(cell, weights, device, pool, kept)
    return dict(e2e=e2e, run=run_info, numbers=numbers, attempted=n,
                failed=0, memory_peak=max(setup_peak, window_peak),
                traced=run_info and run_info["trace"])


def judge(cell, weights, device, pool, kept, ref=None) -> dict:
    """The worst of each number over the requests ``kept`` ({index:
    (output, top-k)}), the reference with ``weights`` in the
    configuration's precision."""
    from .reference.train import normalise
    program.set_math(cell.config)
    if ref is None:
        ref = program.reference_model(cell.config, weights, device).eval()
    worst = {}
    for i, (out, topk) in kept.items():
        clip = pool[i % len(pool)]
        feed = {k: torch.as_tensor(clip[k]).to(device) for k in KEYS}
        feed = normalise(feed, *program.img_norm(cell.config))
        nums = check.serve_numbers(ref, feed, out, topk, cell.limits)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0), v)
    return worst
