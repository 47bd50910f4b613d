"""The msda backward kernel's share of its roofline: the summed least time
of the cell's msda backward calls (``cost/msda.py``, from their shapes)
over the summed device time of ``msda_bwd_kernel`` in the profiled
stretch."""


def read(run):
    trace = run.get("trace")
    if not trace or "msda_bwd_bound_s_per_clip" not in run:
        return None
    spent = trace["by_kind_s"].get("msda backward kernel", 0.0)
    if spent <= 0:
        return None
    return 100.0 * run["msda_bwd_bound_s_per_clip"] * run["trace_clips"] \
        / spent
