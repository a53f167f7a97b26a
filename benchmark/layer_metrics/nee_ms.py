"""Stream milliseconds an iteration in the program's ``bounce.nee`` spans,
every bounce (next-event estimation: the light sample and the shadow
walk; kernels/pathtracing.py), from their CUDA events in the unprofiled
program stretch (harness/program_trace.py); the mean over the ranks.
Serves ``nee_ms.<kind>``."""

from harness.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "bounce.nee")
