"""``mesh_pathtrace`` on the tree the configuration names, with the
program's own record in its traced run.

Runs ``drivers/mesh_pathtrace.py``'s ``run`` unchanged, with two of the
harness's functions swapped for its length and put back when it returns
or raises:

- ``harness.program.scene`` builds the configuration's ``tree`` through
  the program's builder dispatch (``visionaray_torch/ops/sah.py::build``:
  "lbvh" on the card, "sah" or "sbvh" on the host), where
  ``harness/program.py`` builds the LBVH alone;
- ``harness.trace.profile`` returns a summary that also carries
  ``summary["program"]``: the program's spans and counters over the same
  iterations (``harness/program_trace.py::record``), where the span
  readers find them, and the walk's test counters (``walk.<mode>.*``,
  read by ``walk_tests.*``) from one more run of those iterations with
  the walk's counting form on, so that no timed span holds it.  A program
  without the counting form gives no ``walk.*`` counter.

With ``--trace 0`` nothing is added to the window: it times what
``mesh_pathtrace`` times on the same tree.

This is the wiring that ``mesh_pathtrace.py`` and ``harness/program.py``
lack (ROADMAP.md, T9), for the configurations that name this driver.  The
change that folds it into them deletes this file and points those
configurations back at ``mesh_pathtrace``.
"""

from __future__ import annotations


def scene(config: dict, verts, faces, gids, dev):
    """The scene on ``dev`` with the tree ``config["tree"]`` names."""
    from harness import program
    from visionaray_torch.core.scene import Scene
    from visionaray_torch.ops import sah
    m = program.mesh(verts, faces, gids, dev)
    s = Scene.create(mesh=m, materials=program.materials(config, dev),
                     lights=program.lights(config, dev), device=dev)
    s.bvh = sah.build(m, config["tree"])
    return s


def walk_tests(run_iterations) -> dict:
    """The ``walk.*`` counters of one run of ``run_iterations()`` with the
    walk counting its tests, also put on standard error; {} where the
    program cannot."""
    import sys

    from visionaray_torch.utils import metrics
    if not hasattr(metrics, "counting_tests"):
        return {}
    try:
        metrics.enable(True, tests=True)
        metrics.reset()
        run_iterations()
        got = metrics.snapshot()["counters"]
    finally:
        metrics.enable(False)
        metrics.reset()
    walks = {k: v for k, v in got.items() if k.startswith("walk.")}
    print(f"walk tests stretch: {walks}", file=sys.stderr, flush=True)
    return walks


def run(r):
    from harness import program, program_trace, spec
    from harness import trace as tracing

    base = spec.driver("mesh_pathtrace")
    profile, built = tracing.profile, program.scene
    k = r.traffic["trace_iterations"]

    def recorded(run_iterations, *a, **kw):
        summary = profile(run_iterations, *a, **kw)
        rec = program_trace.record(run_iterations, k)
        if rec is not None:
            rec["counters"].update(walk_tests(run_iterations))
        summary["program"] = rec
        return summary

    tracing.profile, program.scene = recorded, scene
    try:
        return base.run(r)
    finally:
        tracing.profile, program.scene = profile, built
