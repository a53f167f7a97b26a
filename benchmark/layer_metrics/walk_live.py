"""Percent of the lanes the LBVH walks carry that are live: over the
bounces, the closest walk's live lanes (``bounce.live``, max_t > 0) and
the shadow walk's (``bounce.shadow``) over the lanes handed to the walks
(``bounce.lanes`` a walk: twice that with NEE, which has a shadow walk a
bounce; once without, which counts no ``bounce.shadow``); the program's
counters in the unprofiled program stretch (harness/program_trace.py),
the forward bounces only; the mean over the ranks.  Serves
``walk_live.<kind>``."""

from harness.program_trace import records


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    shares = []
    for r in recs:
        c = r["counters"]
        walks = 2 if "bounce.shadow" in c else 1
        lanes = walks * sum(c.get("bounce.lanes", []))
        if lanes <= 0:
            return None
        live = sum(c.get("bounce.live", [])) + sum(c.get("bounce.shadow", []))
        shares.append(100.0 * live / lanes)
    return sum(shares) / len(shares)
