"""The share of the profiled stretch with no kernel or copy on the
device."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
