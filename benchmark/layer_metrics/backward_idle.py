"""Percent of the host time in the program's ``step.backward`` span
(sched/step.py: ``torch.autograd.grad``, the recompute inside) in which
the device ran nothing, in the profiled program stretch
(harness/program_trace.py).  Serves ``backward_idle.<kind>``."""

from harness.program_trace import span_idle


def read(ctx):
    return span_idle(ctx, "step.backward")
