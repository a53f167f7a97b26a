"""Ring payload bytes per frame, summed over the ranks
(parallel/comm.py's ``STATS["hop_bytes"]`` over the window)."""


def read(ctx):
    total = sum(c["transport"]["hop_bytes"] for c in ctx["counters"])
    n = ctx["window"].count
    return None if total <= 0 or n == 0 else total / n
