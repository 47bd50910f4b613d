"""Device milliseconds a clip of the kernels classed as GEMM or cuDNN
convolution (``devtrace.py``'s classes), over the profiled stretch."""

KINDS = ("convolution (cuDNN)", "GEMM")


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    return 1e3 * sum(trace["by_kind_s"].get(k, 0.0) for k in KINDS) \
        / run["trace_clips"]
