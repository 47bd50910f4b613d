"""Milliseconds a clip from a request's issue until its clip is on the
card and normalised (``apis.train.model_feed``: the copy and
``apis.prep.device_prep``), read by the benchmark's span that ends in a
synchronise."""


def read(run):
    if "prep_s_per_clip" not in run:
        return None
    return 1e3 * run["prep_s_per_clip"]
