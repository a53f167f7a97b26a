"""Device kernels launched per iteration in the traced window (rank 0):
the launch rate that the bounce loop's glue sets.  Serves
``kernels_per_iter.<kind>``."""

from harness.layers import iterations


def read(ctx):
    tr = ctx["traces"]
    if not tr or tr[0]["kernels"] == 0:
        return None
    return tr[0]["kernels"] / iterations(ctx)
