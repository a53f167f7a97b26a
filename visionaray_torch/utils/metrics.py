"""Timing and per-frame metrics (port of utils/metrics.py; SURVEY §5
observability).

Replaces the reference's wall-clock timer + 0.5s-window FPS counter
(src/common/timer.h:23-49,106-145) and HUD stats (viewer.cpp:371-469) with
an honest device-fenced timer and a structured metrics dict with JSONL
emission for benchmark mode.
"""

from __future__ import annotations

import json
import time
from typing import Optional

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


class FrameCounter:
    """Sliding-window FPS (frame_counter, timer.h:106-145: 0.5 s window)."""

    def __init__(self, window: float = 0.5):
        self.window = window
        self._frames = []

    def register_frame(self) -> float:
        now = time.perf_counter()
        self._frames.append(now)
        cutoff = now - self.window
        self._frames = [t for t in self._frames if t >= cutoff]
        if len(self._frames) < 2:
            return 0.0
        return (len(self._frames) - 1) / (self._frames[-1] - self._frames[0])


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


class MetricsLog:
    """JSONL metrics emitter for benchmark runs."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []

    def emit(self, record: dict):
        self.records.append(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record


def bounce_histogram(params, ray, sampler, nee: bool = False):
    """Per-bounce live-lane counts for a PT batch (SURVEY §5 observability:
    "bounce histogram").  Runs the bounce loop once, counting lanes still
    active entering each bounce — the wavefront occupancy curve that tells
    you how much of the traversal work later bounces actually carry.
    Returns a (num_bounces,) int64 tensor on the rays' device."""
    from visionaray_torch.core.types import Ray
    from visionaray_torch.core.vecmath import faceforward
    from visionaray_torch.ops.trace import closest_hit
    from visionaray_torch.shading.surface import get_surface

    scene = params.scene
    eps = params.epsilon
    samp = sampler
    active = torch.ones(ray.batch_shape, dtype=torch.bool,
                        device=ray.ori.device)
    counts = []
    with torch.no_grad():
        for _ in range(params.num_bounces):
            hit = closest_hit(ray, scene)
            counts.append(active.sum())
            active = active & hit.hit
            surf = get_surface(hit, ray, scene)
            view_dir = -ray.dir
            n = faceforward(surf.shading_normal, view_dir,
                            surf.geometric_normal)
            (u_lobe, u1, u2), samp = samp.next_n(3)
            src, wi, pdf = surf.materials.sample(n, view_dir, u_lobe, u1,
                                                 u2)
            active = active & ~surf.materials.is_emissive() & (pdf > 0.0)
            pos = ray.at(torch.where(hit.hit, hit.t, 1.0))
            ray = Ray(ori=pos + wi * eps, dir=wi)
    return torch.stack(counts)  # live lanes entering each bounce


def scaling_efficiency(mrays_by_devices: dict) -> dict:
    """Efficiency table vs linear scaling from the smallest measured mesh.

    ``mrays_by_devices``: {n_devices: mrays_per_s}.  Returns
    {n: efficiency_percent} with the smallest n as the 100% anchor — the
    north-star's ">=80% linear 1->4 hosts" check."""
    base_n = min(mrays_by_devices)
    base = mrays_by_devices[base_n] / base_n
    return {n: 100.0 * (v / n) / base for n, v in mrays_by_devices.items()}
