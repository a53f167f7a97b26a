"""The traced window: ``torch.profiler`` over a few iterations, reduced to
what the per-layer readers and the result's ``breakdown`` need.

The iterations are traced twice.  The first stretch records the device's
activity alone, which leaves the host's pace as it is untraced, and gives
every number but the gaps' names; the second records the host's
operations too (which slows the host, so its gaps are longer) and only
names the gaps.

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills) in the first stretch; NCCL's kernels are left out of it,
  as a rank that waits in a collective computes nothing;
- ``window_s``: the first stretch's length on the host's clock, from the
  first iteration's start to the synchronize after the last;
- ``ops``: device seconds and counts by operation name (first stretch);
- ``gaps``: the device's idle intervals inside the second stretch, each
  named by the innermost host operation running at its middle ("no host
  op": the host was in Python between operations), seconds by name.

Kernel groups are found by name (``chip_smoke.py::profile_run``'s way).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

MARK = "bench.window"


def _is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "[memory]"))


def union(intervals):
    """Merged (start, end) pairs of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(device, host, window):
    """``device``: (name, start_us, end_us) of device operations; ``host``:
    (name, start_us, end_us) of host operations; ``window``: (start_us,
    end_us).  Returns the summary dict (times in seconds)."""
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    busy = union((s, e) for n, s, e in inside if not _is_nccl(n))
    busy_us = sum(e - s for s, e in busy)
    ops = defaultdict(lambda: [0.0, 0])
    for n, s, e in inside:
        ops[n][0] += (e - s) / 1e6
        ops[n][1] += 1
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    hosts = sorted((s, e, n) for n, s, e in host if n != MARK)
    starts = [h[0] for h in hosts]
    named = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        label = "(no host op: Python)"
        for j in range(i, max(-1, i - 400), -1):
            if hosts[j][1] >= mid:
                label = hosts[j][2]
                break
        named[label] += (e - s) / 1e6
    return dict(
        busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6,
        kernels=sum(c for n, (_, c) in ops.items() if _is_kernel(n)),
        ops={n: v[0] for n, v in ops.items()},
        counts={n: v[1] for n, v in ops.items()},
        gaps=dict(named))


def seconds_of(summary, keys) -> float:
    """Device seconds of the operations whose names hold one of ``keys``."""
    return sum(s for n, s in summary["ops"].items()
               if any(k in n for k in keys))


def top(d: dict, k: int = 10):
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def _events(prof):
    """(device, host) lists of (name, start_us, end_us) of a profile."""
    import torch
    device, host = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(rng)
        else:
            host.append(rng)
    return device, host


def profile(run_iterations, before=None):
    """Trace ``run_iterations()`` (which synchronizes the device at its
    end) twice, as the module's docstring says, calling ``before()``
    (a barrier of the ranks) ahead of each stretch; returns the
    summary."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    cuda = torch.cuda.is_available()
    if before:
        before()
    with prof_ctx(activities=[ProfilerActivity.CUDA] if cuda
                  else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        run_iterations()
        window_s = time.perf_counter() - t0
    device, _ = _events(prof)
    span = (min((s for _, s, _ in device), default=0.0),
            max((e for _, _, e in device), default=0.0))
    out = summarize(device, [], span)
    out["window_s"] = window_s

    if before:
        before()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with prof_ctx(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            run_iterations()
    device, host = _events(prof)
    marks = [(s, e) for n, s, e in host if n == MARK]
    if not marks:
        raise RuntimeError("the profiler lost the window's marker")
    # the marker's device-side copy is no work
    device = [d for d in device if d[0] != MARK]
    out["gaps"] = summarize(device, host, marks[0])["gaps"]
    return out
