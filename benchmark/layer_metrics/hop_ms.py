"""Stream milliseconds an iteration in the program's ``ring.hop`` spans:
one ring step's exchange (parallel/comm.py::_exchange), its wait on the
neighbours included; from their CUDA events in the unprofiled program
stretch (harness/program_trace.py), the mean over the ranks. Serves
``hop_ms.<kind>``."""

from harness.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "ring.hop")
