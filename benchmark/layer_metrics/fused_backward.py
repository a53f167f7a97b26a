"""Percent of the window's bounces whose backward ran as the adjoint
kernel of the two hand shading kernels: launches of
``ENTRY_LAUNCHES["vsnray_bounce_shade_bwd"]`` of ops/traverse.py, in the
program's counters over the window (harness/program.py::counters), over
iterations x samples x bounces; the mean over the ranks.  None where the
counters hold no such entry (a program without the kernel, a run on the
CPU, a window with no backward).  Serves ``fused_backward.<kind>``."""

ENTRY = "vsnray_bounce_shade_bwd"


def read(ctx):
    shapes = ctx["shapes"]
    bounces = ctx["window"].count * shapes["spp"] * shapes["bounces"]
    entries = [c.get("entries", {}) for c in ctx["counters"]]
    if bounces <= 0 or not any(ENTRY in e for e in entries):
        return None
    return sum(100.0 * e.get(ENTRY, 0) / bounces
               for e in entries) / len(entries)
