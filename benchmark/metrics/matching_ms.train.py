"""Host milliseconds a clip in the Hungarian solver: the change of the
program's ``core.assigner.hungarian_assign.seconds`` over the untraced
window."""


def read(run):
    if "matching_s_per_clip" not in run:
        return None
    return 1e3 * run["matching_s_per_clip"]
