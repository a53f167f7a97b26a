"""Percent of the backward's stream time spent in the checkpoint's
recompute: the stream milliseconds of the bounce spans opened inside it
(``recompute=True``) over those of ``step.backward``, from their CUDA
events in the unprofiled program stretch (harness/program_trace.py).
Serves ``recompute_share.<kind>``."""

from harness.program_trace import records

PHASES = ("bounce.closest", "bounce.nee", "bounce.shade")


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    shares = []
    for r in recs:
        back = r["spans"].get("step.backward", {}).get("stream_ms") or 0.0
        again = sum(r["spans"].get(p + "@recompute", {}).get("stream_ms")
                    or 0.0 for p in PHASES)
        if back <= 0 or again <= 0:
            return None
        shares.append(100.0 * again / back)
    return sum(shares) / len(shares)
