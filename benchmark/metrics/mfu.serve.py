"""The whole step's share of the chip's peak in the cell's precision: the
frozen operation count of a clip (``cost/model.py``) times the untraced
window's clips per second, over the dense peak (``cost/peaks.py``)."""


def read(run):
    if "flops_per_clip" not in run:
        return None
    return 100.0 * run["flops_per_clip"] * run["clips_per_s"] \
        / run["peak_flops"]
