"""The program's spans and counters as the benchmark reads them
(harness/program_trace.py and its readers), on synthetic records; and
one record of a tiny frame made on the CPU."""

import pytest

from harness import program_trace as pt
from harness import spec


def read(metric, ctx):
    return spec.reader(metric).read(ctx)


def span(name, t0, t1, stream_ms=None, **tags):
    return dict(name=name, tags=tags, host_ns=[t0, t1], stream_ms=stream_ms)


def test_idle_goes_to_the_innermost_span_by_midpoint():
    spans = [span("step.backward", 0, 100),
             span("bounce.closest", 10, 40, recompute=True),
             span("bounce.shade", 40, 60, recompute=True)]
    # idle: [20, 30] mid 25 in closest; [35, 55] mid 45 in shade (though
    # it starts in closest); [70, 80] in the backward alone; [110, 120]
    # outside every span
    device = [("k", 0, 20), ("k", 30, 35), ("k", 55, 70), ("k", 80, 110),
              ("nccl:SendRecv", 110, 120)]
    gaps = pt.idle_intervals(device, (0, 120))
    assert gaps == [(20, 30), (35, 55), (70, 80), (110, 120)]
    inclusive, innermost = pt.attribute(gaps, spans)
    assert innermost == {"bounce.closest@recompute": 10,
                         "bounce.shade@recompute": 20,
                         "step.backward": 10, pt.OUTSIDE: 10}
    assert inclusive == {"bounce.closest@recompute": 10,
                         "bounce.shade@recompute": 20, "step.backward": 40}


def test_clock_check_pairs_walks_with_their_launching_spans():
    spans = [span("bounce.closest", 0, 10), span("bounce.shade", 10, 20),
             span("bounce.nee", 20, 30), span("bounce.closest", 40, 50),
             span("bounce.closest", 60, 70, recompute=True)]
    # (device start, host launch): launched in closest, nee, closest
    ok = pt.clock_check([(5, 4), (25, 21), (46, 45)], spans)
    assert ok == dict(walks=3, paired=3, after_start=1.0, min_lead_us=5e-3,
                      min_lag_us=1e-3)
    # a device start before its span's host start: the clocks disagree
    early = pt.clock_check([(5, 4), (19, 21), (46, 45)], spans)
    assert early["after_start"] == pytest.approx(2 / 3)
    assert (early["min_lead_us"], early["min_lag_us"]) == (-1e-3, -2e-3)
    # launches outside a launching span, or not known, pair with none
    none = pt.clock_check([(15, 12), (65, 61), (5, None)], spans)
    assert none == dict(walks=3, paired=0, after_start=None,
                        min_lead_us=None, min_lag_us=None)


def _record(**over):
    first = dict(
        spans=[span("bounce.closest", 0, 10, 4.0, bounce=0),
               span("bounce.shade", 10, 12, 1.0, bounce=0),
               span("bounce.nee", 12, 20, 2.5, bounce=0),
               span("bounce.shade", 20, 30, 1.5, bounce=0),
               span("bounce.closest", 30, 40, 3.0, bounce=1),
               span("step.backward", 40, 100, 20.0),
               span("bounce.closest", 50, 60, 5.0, bounce=0,
                    recompute=True),
               span("bounce.shade", 60, 70, 3.0, bounce=0, recompute=True),
               span("bounce.nee", 70, 80, 2.0, bounce=0, recompute=True),
               span("ring.hop", 80, 85, 0.5, direction="forward"),
               span("ring.pack", 85, 86, 0.25)],
        counters={"bounce.lanes": [100, 100], "bounce.live": [100, 60],
                  "bounce.shadow": [80, 20]})
    second = first["spans"]
    device = [("lbvh_kernel", 2, 8), ("mul", 11, 12), ("lbvh_kernel", 14, 19),
              ("add", 21, 100)]
    rec = pt.reduce(first, second, device, [(2, 1), (14, 13)], (0, 100), 2,
                    0.5, 0.45, 40.0, 1)
    rec.update(over)
    return rec


def test_reduce_groups_by_key():
    rec = _record()
    assert rec["spans"]["bounce.closest"] == dict(count=2, stream_ms=7.0,
                                                  host_ms=20e-6)
    assert rec["spans"]["bounce.shade@recompute"]["stream_ms"] == 3.0
    # idle [0, 2], [8, 11], [12, 14], [19, 21]: mids 1 and 9.5 in the
    # first closest, 13 in the nee, 20 on the shade/nee border (both
    # hold it: the shade, started last, is innermost)
    assert rec["idle"]["bounce.closest"] == dict(host_ms=20e-6,
                                                 idle_ms=5e-6)
    assert rec["idle"]["bounce.nee"]["idle_ms"] == pytest.approx(4e-6)
    assert rec["idle_by_span"]["bounce.shade"] == pytest.approx(2e-6)
    assert rec["clock"]["after_start"] == 1.0
    assert rec["clock"]["paired"] == rec["clock"]["walks"] == 2
    assert (rec["seconds"], rec["plain_s"]) == (0.5, 0.45)
    assert rec["hops"] == 1


@pytest.mark.parametrize("metric,value", [
    ("closest_ms.frame", 3.5), ("nee_ms.frame", 1.25),
    ("shade_ms.frame", 1.25), ("hop_ms.frame", 0.25),
    ("pack_ms.frame", 0.125),
    ("closest_idle.frame", 25.0), ("nee_idle.frame", 50.0),
    ("recompute_share.step", 50.0),
    ("walk_live.frame", 65.0), ("walk_live.step", 65.0)])
def test_readers(metric, value):
    ctx = dict(traces=[dict(program=_record())])
    assert read(metric, ctx) == pytest.approx(value)


def test_readers_take_the_mean_over_ranks():
    r0 = _record()
    r1 = _record(counters={"bounce.lanes": [50], "bounce.live": [50],
                           "bounce.shadow": [0]})
    r1["spans"] = dict(r1["spans"], **{"ring.hop": dict(
        count=4, stream_ms=4.5, host_ms=1.0)})
    ctx = dict(traces=[dict(program=r0), dict(program=r1)])
    assert read("hop_ms.frame", ctx) == pytest.approx((0.25 + 2.25) / 2)
    assert read("walk_live.frame", ctx) == pytest.approx((65.0 + 50.0) / 2)


def test_walk_live_without_nee_counts_the_closest_walk_alone():
    # no shadow walk without NEE: bounce.shadow is never counted
    rec = _record(counters={"bounce.lanes": [100, 100],
                            "bounce.live": [100, 60]})
    ctx = dict(traces=[dict(program=rec)])
    assert read("walk_live.frame", ctx) == pytest.approx(80.0)


def test_backward_idle_reads_the_whole_backward():
    first = dict(spans=[span("step.backward", 0, 100, 50.0),
                        span("bounce.closest", 10, 30, 9.0, recompute=True)],
                 counters={})
    device = [("k", 0, 15), ("k", 25, 60), ("k", 80, 100)]
    rec = pt.reduce(first, first["spans"], device, [], (0, 100), 1, 0.1,
                    0.1, 50.0)
    ctx = dict(traces=[dict(program=rec)])
    # idle [15, 25] (in the recompute's span, inside the backward) and
    # [60, 80]: 30 of the backward's 100
    assert read("backward_idle.step", ctx) == pytest.approx(30.0)
    # the recompute's closest spans are not the forward's phase
    assert read("closest_idle.step", ctx) is None


@pytest.mark.parametrize("metric", [
    "closest_ms.frame", "nee_ms.frame", "shade_ms.frame",
    "closest_idle.frame", "nee_idle.frame", "shade_idle.frame",
    "recompute_share.step", "backward_idle.step", "walk_live.frame",
    "walk_live.step", "hop_ms.frame", "pack_ms.frame"])
def test_readers_return_nothing_without_a_record(metric):
    for traces in ([], [{"busy_s": 1.0}], [{"program": None}],
                   [{"program": _record()}, {"busy_s": 1.0}]):
        assert read(metric, dict(traces=traces)) is None
    # a record without the spans or counters the metric reads
    empty = pt.reduce(dict(spans=[], counters={}), [], [], [], (0, 10), 1,
                      0.1, 0.1, None)
    assert read(metric, dict(traces=[dict(program=empty)])) is None


def test_record_of_a_tiny_frame_on_the_cpu():
    import torch

    from visionaray_torch.kernels.params import KernelParams
    from visionaray_torch.scenes.sponza_like import sponza_like_scene
    from visionaray_torch.sched import render
    from visionaray_torch.utils import metrics

    scene, cam = sponza_like_scene(target_tris=300, device="cpu")
    params = KernelParams.create(scene, num_bounces=3, epsilon=1e-3)
    y, x = torch.meshgrid(torch.arange(4), torch.arange(4), indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)

    def traced():
        for f in range(2):
            render.render_pixels(params, cam, x, y, 4, 4, "pathtracing", 1,
                                 "jittered_blend", 1 + f, nee=True)
    rec = pt.record(traced, 2)
    assert rec["iterations"] == 2 and rec["stream_ms"] is None
    assert rec["seconds"] > 0 and rec["plain_s"] > 0
    assert rec["spans"]["bounce.closest"]["count"] == 6
    assert rec["spans"]["bounce.shade"]["count"] == 12
    assert rec["counters"]["bounce.lanes"] == [32, 32, 32]
    assert rec["counters"]["bounce.live"][0] == 32
    # no device on the CPU: the whole profiled stretch is one idle
    # interval, put down to the one span that holds its midpoint
    assert len(rec["idle_by_span"]) == 1
    assert sum(rec["idle_by_span"].values()) == pytest.approx(
        1e3 * rec["profiled_s"], rel=1e-6)
    ctx = dict(traces=[dict(program=rec)])
    assert read("walk_live.frame", ctx) > 0
    # no CUDA events on the CPU: no stream milliseconds to read
    assert rec["spans"]["bounce.nee"]["stream_ms"] is None
    assert read("nee_ms.frame", ctx) is None
    assert metrics.span("x") is metrics.NO_SPAN      # left off
