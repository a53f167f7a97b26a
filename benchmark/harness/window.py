"""The measured window: iterations back to back for a fixed time, each
ended by a device synchronize, and the arithmetic over all of them.

The window opens when the first timed iteration starts and closes when
the first iteration that ends at or past ``seconds`` ends; every
iteration in it counts.  The rate (``step_s``, ``frame_s``) is the window's
seconds over its iterations; ``p95_s`` is the 95th percentile of every
iteration's own wall time (no chunks, no means of slices).
"""

from __future__ import annotations

import resource
import statistics
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float = 0.0           # perf_counter at the first iteration
    end: float = 0.0             # perf_counter after the last one
    start_wall: float = 0.0      # time.time() at the first iteration
    times: list = field(default_factory=list)
    cpu_s: float = 0.0           # the process's CPU seconds in the window
    preempted: int = 0           # its involuntary context switches there

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def count(self) -> int:
        return len(self.times)


def measure(iteration, seconds: float, sync, stop=None) -> Window:
    """Run ``iteration(i)`` then ``sync()`` until ``seconds`` have passed.
    ``stop(elapsed)`` (ranks) decides together whether to go on; it runs
    between iterations, inside the window but outside their times."""
    w = Window(start_wall=time.time())
    cpu0, ru0 = time.process_time(), resource.getrusage(resource.RUSAGE_SELF)
    w.start = t = time.perf_counter()
    i = 0
    while True:
        iteration(i)
        sync()
        now = time.perf_counter()
        w.times.append(now - t)
        i += 1
        w.end = now
        done = now - w.start >= seconds
        if stop is not None:
            done = stop(done)
        if done:
            w.cpu_s = time.process_time() - cpu0
            w.preempted = resource.getrusage(
                resource.RUSAGE_SELF).ru_nivcsw - ru0.ru_nivcsw
            return w
        t = time.perf_counter()


def first_frame(seed: int, warm: int) -> int:
    """The frame number of the window's first iteration, past the
    warm-up's, drawn from the seed."""
    return warm + 1 + int(seed) % (1 << 28)


def per_iteration(w: Window) -> float:
    """The window's seconds over its iterations."""
    return w.seconds / w.count


def p95(times) -> float:
    """The 95th percentile of ``times`` (inclusive quantiles; one value
    is its own percentile)."""
    if len(times) == 1:
        return float(times[0])
    return float(statistics.quantiles(times, n=20, method="inclusive")[18])
