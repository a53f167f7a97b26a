"""The program's own spans and counters over the traced iterations
(``visionaray_torch/utils/metrics.py``), reduced to what the per-layer
readers of the bounce loop, the step and the ring need.

Run after ``harness/trace.py::profile``'s two stretches, on the same
iterations, twice more with the program's tracing on:

1. without a profiler: each span's stream milliseconds (its CUDA events),
   the counters, the stretch's host seconds and stream milliseconds
   (events around the whole stretch); against the window's seconds an
   iteration, the cost of tracing when on;
2. under a profiler that records device activity alone: each idle
   interval of the device in the stretch (NCCL's kernels left out, as
   ``harness/trace.py`` leaves them out of busy) is put down to the
   innermost program span whose host interval holds its midpoint.  The
   spans' host clock is ``time.time_ns()``, the clock of the profiler's
   kineto events (``kineto_results.events()``: ``start_ns()``; the
   ``FunctionEvent`` times are offsets from ``trace_start_ns()`` on it).

Spans are grouped by key: the name, with ``@recompute`` for those opened
inside a checkpoint's recompute.  The record (plain numbers):

- ``iterations``; ``plain_s``: the host seconds of the same iterations
  with tracing off, run just before (after the profiler's stretches, so
  paying what the profiler leaves behind, as the traced ones do);
- ``seconds``, ``stream_ms``: the first stretch's;
- ``spans``: {key: {count, stream_ms, host_ms}} of the first stretch;
- ``counters``: the program's, first stretch; ``hops``: the ring's hops
  in it (``comm.STATS``, read through ``harness/program.py``);
- ``profiled_s``: the second stretch's host seconds;
- ``idle``: {key: {host_ms, idle_ms}} of the second: the idle intervals
  whose midpoint lies in a span of that key (nested spans included);
- ``idle_by_span``: {key: idle_ms}, each interval once, to the innermost
  span ("(no span)": none holds it);
- ``clock``: the walk kernels (``lbvh_kernel``) of the second stretch,
  each with the ``bounce.closest`` or ``bounce.nee`` span whose host
  interval holds the call that launched it (the profiler's launch event
  of the same correlation id): the share that starts on the device no
  earlier than its span's host start.

``record`` returns None for a program without ``metrics.enable``.  A
driver keeps each rank's record beside that rank's device trace, as
``summary["program"]`` of ``harness/trace.py::profile``'s summary, where
the readers find it.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

from harness.layers import WALK_KERNELS
from harness.program import counters
from harness.trace import _is_nccl, union

OUTSIDE = "(no span)"
LAUNCHING = ("bounce.closest", "bounce.nee")


def key_of(span: dict) -> str:
    return span["name"] + ("@recompute" if span["tags"].get("recompute")
                           else "")


def by_key(spans) -> dict:
    """{key: {count, stream_ms, host_ms}} of a snapshot's spans; stream_ms
    None where the spans have no CUDA events (the CPU)."""
    out = defaultdict(lambda: dict(count=0, stream_ms=None, host_ms=0.0))
    for s in spans:
        k = out[key_of(s)]
        k["count"] += 1
        if s["stream_ms"] is not None:
            k["stream_ms"] = (k["stream_ms"] or 0.0) + s["stream_ms"]
        k["host_ms"] += (s["host_ns"][1] - s["host_ns"][0]) / 1e6
    return dict(out)


def idle_intervals(device, window):
    """The device's idle (start, end) intervals inside ``window`` (ns),
    from ``device``: (name, start_ns, end_ns); NCCL's kernels are no
    work."""
    w0, w1 = window
    busy = union((max(s, w0), min(e, w1)) for n, s, e in device
                 if e > w0 and s < w1 and not _is_nccl(n))
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def attribute(gaps, spans):
    """(inclusive, innermost): idle ns by span key.  ``inclusive``: an
    interval counts for every key with a span holding its midpoint;
    ``innermost``: once, for the holding span that started last."""
    order = sorted(spans, key=lambda s: s["host_ns"][0])
    starts = [s["host_ns"][0] for s in order]
    inclusive, innermost = defaultdict(float), defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        holding = [sp for sp in order[:bisect.bisect_right(starts, mid)]
                   if sp["host_ns"][1] >= mid]
        for k in {key_of(sp) for sp in holding}:
            inclusive[k] += e - s
        innermost[key_of(holding[-1]) if holding else OUTSIDE] += e - s
    return dict(inclusive), dict(innermost)


def clock_check(walks, spans):
    """``walks``: (start_ns, launch_ns) of the walk kernels, launch_ns the
    host time of the call that launched each (None: not known).  Each is
    paired with the ``bounce.closest`` or ``bounce.nee`` span (not the
    recompute's) whose host interval holds its launch; returns the
    number of walks, how many found their span, the share of those that
    start on the device no earlier than their span's host start, and the
    least device start less span start and less launch (us)."""
    launching = [s["host_ns"] for s in spans if s["name"] in LAUNCHING
                 and not s["tags"].get("recompute")]
    leads, lags = [], []
    for start, launch in walks:
        holder = [h for h in launching
                  if launch is not None and h[0] <= launch <= h[1]]
        if holder:
            leads.append(start - holder[0][0])
            lags.append(start - launch)
    return dict(walks=len(walks), paired=len(leads),
                after_start=sum(v >= 0 for v in leads) / len(leads)
                if leads else None,
                min_lead_us=min(leads) / 1e3 if leads else None,
                min_lag_us=min(lags) / 1e3 if lags else None)


def reduce(first: dict, second: list, device, walks, window,
           iterations: int, seconds: float, plain_s: float,
           stream_ms, hops: int = 0) -> dict:
    """The record from the first stretch's snapshot and ring hops, the
    second's spans, its device events (name, start_ns, end_ns), walk
    kernels (start_ns, launch_ns) and host window (ns)."""
    gaps = idle_intervals(device, window)
    inclusive, innermost = attribute(gaps, second)
    host = by_key(second)
    return dict(
        iterations=iterations, seconds=seconds, plain_s=plain_s,
        stream_ms=stream_ms, profiled_s=(window[1] - window[0]) / 1e9,
        spans=by_key(first["spans"]), counters=first["counters"],
        hops=hops,
        idle={k: dict(host_ms=v["host_ms"],
                      idle_ms=inclusive.get(k, 0.0) / 1e6)
              for k, v in host.items()},
        idle_by_span={k: v / 1e6 for k, v in innermost.items()},
        clock=clock_check(walks, second))


def _device_events(prof):
    """(device, walks) of a profile on the host's clock (ns): device
    operations (name, start, end), and the walk kernels (start, host
    start of the call that launched each, or None)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != cuda and "Launch" in e.name()}
    device = [e for e in events if e.device_type() == cuda]
    walks = [(e.start_ns(), launch.get(e.correlation_id()))
             for e in device if any(k in e.name() for k in WALK_KERNELS)]
    return [(e.name(), e.start_ns(), e.end_ns()) for e in device], walks


def _timed(run_iterations, cuda: bool):
    """(host seconds, stream milliseconds or None) of one stretch."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if cuda else None
    t0 = time.perf_counter()
    if cuda:
        ev[0].record()
    run_iterations()
    if cuda:
        ev[1].record()
    seconds = time.perf_counter() - t0
    return seconds, ev[0].elapsed_time(ev[1]) if cuda else None


def record(run_iterations, iterations: int, before=None):
    """Run ``run_iterations()`` (which synchronizes at its end) once with
    the program's tracing off, for the cost of tracing, then twice with
    it on, as the module's docstring says, calling ``before()`` (a
    barrier of the ranks) ahead of each; returns the record, or None
    where the program has no tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from visionaray_torch.utils import metrics
    if not hasattr(metrics, "enable"):
        return None
    cuda = torch.cuda.is_available()
    if before:
        before()
    plain_s, _ = _timed(run_iterations, cuda)
    try:
        metrics.enable(True)
        if before:
            before()
        metrics.reset()
        hops = counters()["transport"]["hops"]
        seconds, stream_ms = _timed(run_iterations, cuda)
        first = metrics.snapshot()
        hops = counters()["transport"]["hops"] - hops

        if before:
            before()
        metrics.reset()
        with profile(activities=[ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            w0 = time.time_ns()
            run_iterations()
            w1 = time.time_ns()
        second = metrics.snapshot()["spans"]
    finally:
        metrics.enable(False)
        metrics.reset()
    device, walks = _device_events(prof)
    rec = reduce(first, second, device, walks, (w0, w1), iterations,
                 seconds, plain_s, stream_ms, hops)
    log(rec)
    return rec


def log(rec: dict):
    """One line on standard error: the stretch, its phases, counters and
    the clock check."""
    n = rec["iterations"]
    phases = "; ".join(
        f"{k} {v['count'] / n:g}x {(v['stream_ms'] or 0.0) / n:.4f} ms"
        for k, v in sorted(rec["spans"].items()))
    idle = "; ".join(f"{k} {v['idle_ms']:.3f}/{v['host_ms']:.3f} ms"
                     for k, v in sorted(rec["idle"].items()))
    print(f"program stretch: {n} iterations in {rec['seconds']:.6f} s "
          f"(tracing off: {rec['plain_s']:.6f} s), stream "
          f"{rec['stream_ms']} ms; spans an iteration: {phases}; "
          f"idle/host (profiled): {idle}; innermost idle: "
          f"{rec['idle_by_span']}; counters {rec['counters']}; "
          f"hops {rec['hops']}; "
          f"clock {rec['clock']}", file=sys.stderr, flush=True)


def records(ctx):
    """The ranks' records of a traced run (``program`` of each rank's
    trace summary), or None where the run has none."""
    recs = [t.get("program") for t in ctx.get("traces") or []]
    if not recs or any(r is None for r in recs):
        return None
    return recs


def span_ms(ctx, key: str):
    """Stream milliseconds an iteration in spans of ``key``, the mean over
    the ranks; None without records, such spans or their CUDA events."""
    recs = records(ctx)
    if recs is None or any(r["spans"].get(key, {}).get("stream_ms") is None
                           for r in recs):
        return None
    return sum(r["spans"][key]["stream_ms"] / r["iterations"]
               for r in recs) / len(recs)


def span_idle(ctx, key: str):
    """Percent of the host time in spans of ``key`` in which the device
    idled (the profiled stretch), the mean over the ranks."""
    recs = records(ctx)
    if recs is None or any(r["idle"].get(key, {}).get("host_ms", 0) <= 0
                           for r in recs):
        return None
    return sum(100.0 * r["idle"][key]["idle_ms"] / r["idle"][key]["host_ms"]
               for r in recs) / len(recs)
