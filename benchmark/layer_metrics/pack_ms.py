"""Stream milliseconds an iteration in the program's ``ring.pack`` spans:
the payload's concatenation before a hop and its split after
(parallel/ring.py::_ring_step); from their CUDA events in the unprofiled
program stretch (harness/program_trace.py), the mean over the ranks.
Serves ``pack_ms.<kind>``."""

from harness.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "ring.pack")
