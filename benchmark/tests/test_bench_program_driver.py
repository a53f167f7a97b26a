"""``drivers/mesh_pathtrace_program.py`` and ``layer_metrics/walk_tests.py``:
a run of the x16 cell walks the tree its configuration names; a traced
run carries the program's record, with the walk's test counters from a
stretch of their own, and reads its walk's tests a ray; the driver puts
``harness.trace.profile`` and ``harness.program.scene`` back whether
``mesh_pathtrace`` returns or raises; a program without the walk's
counting form gives no ``walk.*`` counter; the reader sums the walk's
counters over modes and ranks, and reads nothing without them."""

import types

import pytest

import run as bench_run
from harness import program, spec
from harness import trace as tracing
from tiny import tiny_run

CELL = "sponza_x16.frame"


def _spy_trees(monkeypatch):
    """The builder of every tree the run builds, and the tree."""
    from visionaray_torch.ops import sah
    built, real = [], sah.build

    def build(mesh, builder="lbvh"):
        bvh = real(mesh, builder)
        built.append((builder, bvh))
        return bvh
    monkeypatch.setattr(sah, "build", build)
    return built


def test_traced_run_carries_the_program_record(monkeypatch):
    from visionaray_torch.utils import metrics
    profile, scene = tracing.profile, program.scene
    built = _spy_trees(monkeypatch)
    seen = []

    def counting(*a, **k):      # the walk's counting form, and when
        seen.append(metrics.counting_tests())
        return walk(*a, **k)

    from visionaray_torch.ops import traversal
    walk = traversal.traverse_bvh_plain
    monkeypatch.setattr(traversal, "traverse_bvh_plain", counting)
    r = tiny_run(CELL, trace=True)
    rec = spec.driver(r.config["driver"]).run(r)
    assert tracing.profile is profile and program.scene is scene
    assert [b for b, _ in built] == ["sbvh"]
    assert built[0][1].leaf_first is not None      # generalized leaves
    program_rec = rec["traces"][0]["program"]
    assert program_rec is not None and program_rec["iterations"] == 1
    c = program_rec["counters"]
    assert c["walk.closest.rays"] > 0 and c["walk.any.rays"] > 0
    assert c["bounce.lanes"]                 # the spans' stretch's own
    # the walks of the window, warm-up, profiler and spans' stretches
    # count nothing; only those of the tests' stretch (two a bounce)
    walks = 2 * r.traffic["bounces"] * r.traffic["trace_iterations"]
    assert sum(seen) == walks and seen[-walks:] == [True] * walks
    assert not metrics.enabled() and not metrics.counting_tests()
    res = bench_run.evaluate(r, rec)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["walk_tests.x16"]["value"] > 0


def test_untraced_run_carries_no_record(monkeypatch):
    built = _spy_trees(monkeypatch)
    r = tiny_run(CELL)
    rec = spec.driver(r.config["driver"]).run(r)
    assert rec["traces"] == []
    assert [b for b, _ in built] == ["sbvh"]


def test_program_without_test_counts_gives_none(monkeypatch):
    """The parent's program (spans and counters, no counting form): the
    tests' stretch runs nothing and adds no counter."""
    from visionaray_torch.utils import metrics
    monkeypatch.delattr(metrics, "counting_tests")
    ran = []
    drv = spec.driver("mesh_pathtrace_program")
    assert drv.walk_tests(lambda: ran.append(1)) == {}
    assert ran == [] and not metrics.enabled()


def test_profile_is_put_back_after_a_raise(monkeypatch):
    profile, scene = tracing.profile, program.scene
    seen = []

    def failing(r):
        seen.append(tracing.profile is not profile
                    and program.scene is not scene)
        raise RuntimeError("the frame failed")

    real = spec.driver
    monkeypatch.setattr(spec, "driver", lambda name: types.SimpleNamespace(
        run=failing) if name == "mesh_pathtrace" else real(name))
    drv = real("mesh_pathtrace_program")
    with pytest.raises(RuntimeError, match="the frame failed"):
        drv.run(tiny_run(CELL, trace=True))
    assert seen == [True]
    assert tracing.profile is profile and program.scene is scene


def _ctx(*counters):
    return dict(traces=[dict(program=dict(counters=c)) for c in counters])


def test_walk_tests_reader():
    read = spec.reader("walk_tests.x16").read
    one = {"walk.closest.rays": 10, "walk.closest.box": 300,
           "walk.closest.prim": 20, "walk.any.rays": 5, "walk.any.box": 70,
           "walk.any.prim": 10, "bounce.lanes": [99]}
    assert read(_ctx(one)) == pytest.approx(400 / 15)
    two = {"walk.closest.rays": 4, "walk.closest.box": 36,
           "walk.closest.prim": 4}
    assert read(_ctx(one, two)) == pytest.approx((400 / 15 + 10) / 2)
    # the parent's record: spans and bounce counters, no walk counters
    assert read(_ctx({"bounce.lanes": [99]})) is None
    assert read(_ctx(one, {})) is None
    assert read(dict(traces=[])) is None
    assert read(dict(traces=[dict(program=None)])) is None
