"""Percent of the host time in the program's ``bounce.closest`` spans in
which the device ran nothing: the idle intervals whose midpoint falls in
such a span over those spans' host time, in the profiled program stretch
(harness/program_trace.py); the mean over the ranks. Serves
``closest_idle.<kind>``."""

from harness.program_trace import span_idle


def read(ctx):
    return span_idle(ctx, "bounce.closest")
