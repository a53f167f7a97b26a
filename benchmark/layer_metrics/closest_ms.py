"""Stream milliseconds an iteration in the program's ``bounce.closest``
spans, every bounce (the closest walk with its hit record and surface
gathers; kernels/pathtracing.py), from their CUDA events in the
unprofiled program stretch (harness/program_trace.py); the mean over the
ranks. Serves ``closest_ms.<kind>``."""

from harness.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "bounce.closest")
