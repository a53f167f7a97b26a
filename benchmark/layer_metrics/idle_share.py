"""Percent of the traced window in which the device runs nothing: 1 - the
device-busy seconds (the union of its operations' intervals, NCCL's
kernels left out) over the window's seconds, both from the stretch that
records device activity alone (harness/trace.py); the mean over the
ranks.  Serves ``idle_share.<kind>`` of every cell."""


def read(ctx):
    tr = ctx["traces"]
    if not tr or any(s["busy_s"] <= 0 for s in tr):
        return None
    return 100.0 * sum(1.0 - s["busy_s"] / s["window_s"] for s in tr) \
        / len(tr)
