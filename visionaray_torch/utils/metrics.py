"""Timing, memory and the program's own tracing (port of
utils/metrics.py; SURVEY §5 observability).

Replaces the reference's wall-clock timer (src/common/timer.h:23-104) and
HUD stats (viewer.cpp:371-469) with a device-fenced timer and a
structured metrics dict.

Tracing: spans and counters inside the program, off by default.

- ``span(name, **tags)``: a context manager around a piece of the
  program's work.  On, it records the name and tags, its host interval
  on ``time.time_ns()`` (the clock ``torch.profiler``'s event times are
  offsets on, from ``kineto_results.trace_start_ns()``) and, on CUDA, a
  pair of timing events on the current stream, whose elapsed time is
  read in ``snapshot()``: no synchronize on the path.  Spans opened
  inside ``recomputing()`` (a checkpoint's recompute, which
  kernels/pathtracing.py's checkpoint enters) carry ``recompute=True``.
- ``count(name, value, index=None)``: adds ``value`` (an int, or a
  tensor whose sum is added: a mask counts its true entries) to the
  counter ``name`` (``name[index]`` for an index).  Tensor sums stay on
  the device until ``snapshot()``.  Nothing is counted inside a recompute.
- ``enable(on, tests=False)``, ``reset()``, ``snapshot()``: switch,
  clear, and read the spans and counters since the last reset;
  ``enabled()``: whether a count would be kept now (on, outside a
  recompute).  ``tests`` also has the walk count its box and primitive
  tests (``counting_tests()``; ``ops/traversal.py``'s ``walk.<mode>.*``):
  a slower form of the walk, so a stretch whose spans are timed leaves it
  off.  The walk's launch counters and the ring's transport counters stay
  with their owners, ``ops/traverse.py`` and ``parallel/comm.py``.

Off, ``span`` returns one shared no-op object and ``count`` returns at
once: neither reads a clock, makes a CUDA event, allocates or launches.
No span is a ``record_function`` or NVTX range, so a profiler's device
timeline holds only the program's own work.
"""

from __future__ import annotations

import time

import torch


def _fence(x):
    """Wait for the devices of the CUDA tensors in ``x``."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _fence(v)


class Timer:
    """Wall-clock timer with explicit device fencing (timer.h:23 analogue).

    ``elapsed(x)`` with a CUDA tensor (or a tuple or list holding one)
    synchronizes its device before reading the clock, the
    cudaEventSynchronize of timer.h:52-104.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self, fence=None) -> float:
        if fence is not None:
            _fence(fence)
        return time.perf_counter() - self._t0


def frame_metrics(width: int, height: int, spp: int, bounces: int,
                  seconds: float, n_prims: int, algo: str,
                  n_devices: int = 1) -> dict:
    """Structured per-frame metric dict (rays/s, per-chip rates)."""
    rays = width * height * spp * (1 if algo == "simple" else bounces)
    return {
        "algo": algo,
        "resolution": [width, height],
        "spp": spp,
        "bounces": bounces,
        "prims": n_prims,
        "frame_ms": seconds * 1e3,
        "mrays_per_s": rays / seconds / 1e6,
        "mrays_per_s_per_chip": rays / seconds / 1e6 / max(n_devices, 1),
        "devices": n_devices,
    }


def memory_stats(device=None) -> dict:
    """Device memory of the work so far, the counterpart of the JAX
    package's compiled-memory query: PyTorch runs no compiled executable,
    so this reads the CUDA caching allocator's peak allocated and reserved
    bytes (and the allocated bytes now) of ``device`` (default: the
    current CUDA device), in MiB.  {} on the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {
        "peak_allocated_mb": round(
            torch.cuda.max_memory_allocated(dev) / 2**20, 2),
        "peak_reserved_mb": round(
            torch.cuda.max_memory_reserved(dev) / 2**20, 2),
        "allocated_mb": round(torch.cuda.memory_allocated(dev) / 2**20, 2),
    }


def scaling_efficiency(mrays_by_devices: dict) -> dict:
    """Efficiency table vs linear scaling from the smallest measured mesh.

    ``mrays_by_devices``: {n_devices: mrays_per_s}.  Returns
    {n: efficiency_percent} with the smallest n as the 100% anchor — the
    north-star's ">=80% linear 1->4 hosts" check."""
    base_n = min(mrays_by_devices)
    base = mrays_by_devices[base_n] / base_n
    return {n: 100.0 * (v / n) / base for n, v in mrays_by_devices.items()}


class _NoSpan:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
_POOL_EVENTS = 1024        # timing events the pool is made with, and grows by


class _Recorder:
    """The spans and counters of this process since the last reset."""

    def __init__(self):
        self.on = False
        self.tests = False      # the walk counts its tests too
        self.cuda = False
        self.recompute = False  # inside a checkpoint's recompute
        self.spans = []         # [name, tags, t0_ns, t1_ns, events or None]
        self.counts = {}        # name -> {index: int or device tensor}
        self.pool = []          # torch.cuda.Event(enable_timing=True)
        self.used = 0

    def events(self):
        """Two timing events from the pool, made on first use and grown
        when it runs out; ``reset`` hands them out again."""
        if self.used + 2 > len(self.pool):
            self.pool += [torch.cuda.Event(enable_timing=True)
                          for _ in range(_POOL_EVENTS)]
        a, b = self.pool[self.used:self.used + 2]
        self.used += 2
        return a, b


_REC = _Recorder()


class recomputing:
    """Context: the work inside is a checkpoint's recompute.  Its spans
    carry ``recompute=True`` and it counts nothing."""

    def __enter__(self):
        self.saved = _REC.recompute
        _REC.recompute = True

    def __exit__(self, *exc):
        _REC.recompute = self.saved


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, tags: dict):
        if _REC.recompute:
            tags["recompute"] = True
        self.rec = [name, tags, 0, 0, None]

    def __enter__(self):
        r = self.rec
        r[2] = time.time_ns()
        if _REC.cuda:
            r[4] = _REC.events()
            r[4][0].record()
        _REC.spans.append(r)
        return self

    def __exit__(self, *exc):
        r = self.rec
        if r[4] is not None:
            r[4][1].record()
        r[3] = time.time_ns()
        return False


def enable(on: bool = True, tests: bool = False):
    """Turn tracing on or off (off by default); ``tests``: with it on, the
    walk counts its tests too (``counting_tests``)."""
    _REC.on = bool(on)
    _REC.tests = _REC.on and bool(tests)
    _REC.cuda = _REC.on and torch.cuda.is_available()


def enabled() -> bool:
    """Whether tracing is on and the work is outside a recompute: whether
    ``count`` would keep a value."""
    return _REC.on and not _REC.recompute


def counting_tests() -> bool:
    """Whether the walk should count its box and primitive tests now:
    tracing on with ``tests``, outside a recompute."""
    return _REC.tests and enabled()


def reset():
    """Forget the spans and counters."""
    _REC.spans, _REC.counts, _REC.used = [], {}, 0


def span(name: str, **tags):
    """A context manager that records ``name``'s span while tracing is on,
    else the shared no-op."""
    if not _REC.on:
        return NO_SPAN
    return _Span(name, tags)


def count(name: str, value, index=None):
    """Add ``value`` to counter ``name`` (at ``index``) while tracing is on
    and outside a recompute."""
    if not enabled():
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
    slot = _REC.counts.setdefault(name, {})
    slot[index] = value if index not in slot else slot[index] + value


def snapshot() -> dict:
    """Everything recorded since the last reset, as plain numbers:

    - ``spans``: in the order they opened, each {name, tags, host_ns:
      [start, end] on ``time.time_ns()``, stream_ms: the CUDA events'
      elapsed milliseconds or None}; spans still open are left out;
    - ``counters``: {name: int, or a list by index for indexed ones}.

    Waits for the device once, here."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    spans = [dict(name=n, tags=dict(tags), host_ns=[t0, t1],
                  stream_ms=ev[0].elapsed_time(ev[1]) if ev else None)
             for n, tags, t0, t1, ev in _REC.spans if t1]
    counters = {}
    for name, slot in _REC.counts.items():
        if set(slot) == {None}:
            counters[name] = int(slot[None])
        else:
            counters[name] = [int(slot.get(i, 0))
                              for i in range(max(slot) + 1)]
    return dict(spans=spans, counters=counters)
