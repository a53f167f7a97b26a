"""The window's arithmetic, the walk's bound from shapes, and the traced
window's reduction, on synthetic numbers."""

import math
import statistics
import time

import pytest

from harness import roofline, spec, trace, window


def read(metric, ctx):
    return spec.reader(metric).read(ctx)


def test_rate_is_window_over_iterations():
    w = window.Window(start=10.0, end=13.0, times=[0.5, 0.5, 1.0, 0.5])
    # the gaps between iterations count in the window, not in the times
    assert window.per_iteration(w) == pytest.approx(0.75)
    assert window.per_iteration(w) != statistics.mean(w.times)


def test_p95_over_every_iteration():
    times = [0.1] * 95 + [1.0] * 5
    # over all 100: the 95th percentile sits where the slow ones begin
    assert window.p95(times) == pytest.approx(
        statistics.quantiles(times, n=20, method="inclusive")[18])
    # a mean of per-chunk percentiles would read otherwise
    chunks = [times[i:i + 10] for i in range(0, 100, 10)]
    chunked = statistics.mean(window.p95(c) for c in chunks)
    assert window.p95(times) != pytest.approx(chunked)
    assert window.p95([0.3]) == 0.3


def test_measure_counts_every_iteration_until_the_deadline():
    seen = []

    def it(i):
        seen.append(i)
        time.sleep(0.01)

    w = window.measure(it, 0.1, lambda: None)
    assert w.count == len(seen) == len(w.times)
    assert seen == list(range(w.count))
    assert w.seconds >= 0.1 and w.seconds - w.times[-1] < 0.1
    assert w.seconds >= sum(w.times)


def test_measure_stops_when_the_ranks_say_so():
    calls = []

    def stop(done):
        calls.append(done)
        return len(calls) == 3

    w = window.measure(lambda i: None, 100.0, lambda: None, stop)
    assert w.count == 3 and calls == [False, False, False]


def test_walk_bound_from_shapes():
    shapes = dict(triangles=259_656, width=1920, height=1080, spp=1,
                  bounces=5)
    rays = 1920 * 1080 * 5 * 2
    nbytes = rays * 48 + 259_656 * 36 + (2 * 259_656 - 1) * 24
    ops = rays * (18 * 40 + 40)
    assert math.ceil(math.log2(259_656)) == 18
    want = max(nbytes / 3.35e12, ops / 67e12)
    assert roofline.walk_bound_s(shapes) == pytest.approx(want)
    # at 1080p the bytes bound it: ~0.30 ms a step or frame
    assert nbytes / 3.35e12 > ops / 67e12
    assert roofline.walk_bound_s(shapes) == pytest.approx(3.04e-4, rel=0.01)


def test_idle_share_from_events():
    device = [("lbvh_kernel<1>", 10.0, 20.0), ("elementwise", 15.0, 30.0),
              ("Memcpy DtoH", 50.0, 60.0), ("ncclKernel_AllGather", 60.0,
                                            90.0)]
    host = [("aten::nonzero", 30.0, 50.0), ("cudaStreamSynchronize", 35.0,
                                              45.0),
            ("aten::mul", 70.0, 100.0)]
    s = trace.summarize(device, host, (0.0, 100.0))
    # busy: [10, 30] and [50, 60]; NCCL's wait is not work
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernels"] == 3
    assert trace.seconds_of(s, ("lbvh_kernel",)) == pytest.approx(10e-6)
    # gaps [0, 10], [30, 50], [60, 100], named by the innermost host op
    assert s["gaps"]["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert s["gaps"]["aten::mul"] == pytest.approx(40e-6)
    assert s["gaps"]["(no host op: Python)"] == pytest.approx(10e-6)
    # two iterations of 15 us busy each; idle is the window's 70 us of 100
    ctx = dict(traces=[s], shapes=dict(traced_iterations=2))
    assert read("idle_share.frame", ctx) == pytest.approx(70.0)
    assert read("kernels_per_iter.frame", ctx) == pytest.approx(1.5)
    assert read("glue_ms.frame", ctx) == pytest.approx(1e3 * (15e-6 - 5e-6))
    # ranks: the mean of each rank's idle share
    half = dict(s, busy_s=50e-6)
    ctx2 = dict(ctx, traces=[s, half])
    assert read("idle_share.sharded", ctx2) == pytest.approx(60.0)


def test_readers_return_nothing_without_device_time():
    s = trace.summarize([], [("aten::add", 0.0, 5.0)], (0.0, 10.0))
    ctx = dict(traces=[s], shapes=dict(traced_iterations=1, triangles=10,
                                       width=2, height=2, spp=1, bounces=1))
    for m in ("idle_share.step", "walk_roofline.step", "glue_ms.step",
              "kernels_per_iter.step"):
        assert read(m, ctx) is None, m


def test_union():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_judge_keeps_the_line_plain_json():
    import json

    from harness import check
    ok, checks = check.judge({"a": float("nan"), "b": 0.5},
                             {"a": 1.0, "b": 1.0, "c": 1.0})
    assert not ok
    assert checks["a"]["value"] == check.NO_READING
    assert checks["c"]["value"] == check.NO_READING
    assert checks["b"] == {"value": 0.5, "limit": 1.0}
    json.loads(json.dumps(checks), parse_constant=lambda c: 1 / 0)
    assert check.judge({"a": 1.0}, {"a": 1.0})[0]


def test_reference_normalize_guards_zero_in_bfloat16_only():
    """The control (the reference in bfloat16) keeps a vector rounded to
    zero finite; in float32 the reference is unchanged, bit for bit."""
    import torch

    from reference import pathtrace
    z = torch.zeros((2, 3))
    v = torch.tensor([[3.0, 4.0, 0.0], [1e-3, 2e-3, -5.0]])
    assert torch.isnan(pathtrace.normalize(z)).all()
    assert torch.equal(pathtrace.normalize(v),
                       v * torch.rsqrt((v * v).sum(-1))[:, None])
    assert torch.equal(pathtrace.normalize(z.bfloat16()),
                       z.bfloat16())
    assert torch.isfinite(pathtrace.normalize(v.bfloat16())).all()
