"""Stream milliseconds an iteration in the program's ``bounce.shade``
spans, every bounce (the rest of the bounce: samples, material sample,
weights, carry updates, the next ray; kernels/pathtracing.py), from
their CUDA events in the unprofiled program stretch
(harness/program_trace.py); the mean over the ranks. Serves
``shade_ms.<kind>``."""

from harness.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "bounce.shade")
