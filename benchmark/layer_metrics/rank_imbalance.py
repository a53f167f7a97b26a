"""The slowest rank's device-busy seconds over the mean rank's in the
traced window (x); None on one rank."""


def read(ctx):
    busy = [s["busy_s"] for s in ctx["traces"]]
    if len(busy) < 2 or min(busy) <= 0:
        return None
    return max(busy) / (sum(busy) / len(busy))
