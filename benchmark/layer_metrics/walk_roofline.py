"""The LBVH walk's share of its roofline per iteration: the least time the
chip could take for the iteration's walks (harness/roofline.py, from the
cell's shapes) over the device time of traverse_lbvh.cu's kernels, by
name (rank 0).  Serves ``walk_roofline.<kind>``."""

from harness.layers import walk_s
from harness.roofline import walk_bound_s


def read(ctx):
    if not ctx["traces"]:
        return None
    w = walk_s(ctx)
    return None if w <= 0 else 100.0 * walk_bound_s(ctx["shapes"]) / w
