"""Reduction of ``torch.profiler`` traces of a steady stretch of a run to
what the per-layer metrics read (frozen from the port's
``tools/profile_train.py``: the same kernel classes by name, first match
wins, and the device time of each kernel and copy, not of the device-side
ranges of ``record_function`` annotations).

``trace(device_pass, host_pass)`` profiles ``device_pass`` with device
activity alone, which costs the host little, and reads from it
``window_s`` (host clock over the pass, which ends in a synchronise),
``busy_s`` (the union of the device intervals), ``by_kind_s`` and
``by_name_s`` (summed device seconds) and ``device_ops`` (the ten longest
by name). It then profiles ``host_pass`` with the host's operations too,
which slows the host, only to name the ten longest stretches with nothing
on the device by the innermost host operation running when each began
(``idle_gaps``).
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Callable

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


def _profile(fn, host: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof.events(), window_s


def _device_intervals(events):
    from torch.autograd import DeviceType
    for e in events:
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            yield e.time_range.start, e.time_range.end, e.name


def _busy_and_gaps(intervals):
    """Union length of ``(start, end)`` intervals (us) and the gaps
    between its pieces."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def trace(device_pass: Callable[[], None],
          host_pass: Callable[[], None]) -> dict:
    events, window_s = _profile(device_pass, host=False)
    by_kind, by_name, spans = defaultdict(float), defaultdict(float), []
    for start, end, name in _device_intervals(events):
        by_kind[kind_of(name)] += (end - start) / 1e6
        by_name[name] += (end - start) / 1e6
        spans.append((start, end))
    busy_us, _ = _busy_and_gaps(spans)

    from torch.autograd import DeviceType
    events, _ = _profile(host_pass, host=True)
    _, gaps = _busy_and_gaps([(s, e) for s, e, _ in
                              _device_intervals(events)])
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inner = [h for h in host if h[0] <= a < h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "-"
        idle.append([name, (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=window_s, busy_s=busy_us / 1e6,
                by_kind_s=dict(by_kind), by_name_s=dict(by_name),
                device_ops=[[k, v] for k, v in ops], idle_gaps=idle)
