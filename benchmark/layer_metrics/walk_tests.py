"""Tests a live ray makes in the BVH walk (``traverse_lbvh.cu``, any of
the flat trees: LBVH, SAH, SBVH): box plus primitive tests over the rays
that tested anything, summed over every walk and mode of one run of the
traced iterations with the walk's counting form on,
Σ(walk.<mode>.box + walk.<mode>.prim) / Σ walk.<mode>.rays of the
program's counters (ops/traversal.py counts them while tracing counts
tests; ``drivers/mesh_pathtrace_program.py`` runs that stretch apart from
the timed ones of harness/program_trace.py); the mean over the ranks.
Apart from the walk's time (``walk_roofline``), it tells a deeper or
coarser tree (more tests a ray) from dearer tests.  None where the record
holds no ``walk.*`` counter.  Serves ``walk_tests.<kind>``."""

from harness.program_trace import records


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    means = []
    for r in recs:
        c = {k: v for k, v in r["counters"].items() if k.startswith("walk.")}
        rays = sum(v for k, v in c.items() if k.endswith(".rays"))
        tests = sum(v for k, v in c.items()
                    if k.endswith((".box", ".prim")))
        if rays <= 0:
            return None
        means.append(tests / rays)
    return sum(means) / len(means)
