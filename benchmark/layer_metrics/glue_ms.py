"""Device-busy milliseconds per iteration outside the LBVH walk kernels:
the frame and bounce loop's gathers, shading, sampling and copies, and in
a step the backward's recompute (sched/render.py, kernels/pathtracing.py,
shading/); rank 0.  Serves ``glue_ms.<kind>``."""

from harness.layers import iterations, walk_s


def read(ctx):
    tr = ctx["traces"]
    if not tr or tr[0]["busy_s"] <= 0:
        return None
    return 1e3 * (tr[0]["busy_s"] / iterations(ctx) - walk_s(ctx))
