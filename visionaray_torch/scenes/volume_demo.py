"""Procedural volume scenes (port of scenes/volume_demo.py; reference
examples/volume/main.cpp:69-107 and examples/multi_volume/main.cpp).

The fields are made with numpy on the host, as the JAX package makes
them, then moved to ``device``.
"""

from __future__ import annotations

import numpy as np

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Scene
from visionaray_torch.device import resolve_device
from visionaray_torch.kernels.volume import Volumes


def _grid(n: int):
    ax = (np.arange(n, dtype=np.float32) + 0.5) / n * 2.0 - 1.0
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return z, y, x, np.sqrt(x * x + y * y + z * z)


def volume_scene(resolution: int = 64, device="cuda"):
    """One AABB-bounded volume in [-1, 1]^3: a soft shell at r = 0.7 under
    an angular ripple plus a dense core, through a blue-to-orange transfer
    ramp.  Returns (scene, camera)."""
    dev = resolve_device(device)
    z, y, x, r = _grid(resolution)
    shell = np.exp(-((r - 0.7) / 0.12) ** 2)
    core = np.exp(-((r - 0.15) / 0.2) ** 2)
    ripple = 0.5 + 0.5 * np.sin(6.0 * np.arctan2(y, x)) * np.cos(5.0 * z)
    field = np.clip(0.8 * shell * ripple + core, 0.0, 1.0)

    t = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    transfer = np.stack([
        0.2 + 0.8 * t,                       # R ramps up
        0.1 + 0.5 * np.sin(np.pi * t),       # G peaks mid-range
        0.9 - 0.8 * t,                       # B ramps down
        np.where(t < 0.05, 0.0, t ** 1.5),   # opacity gated at low density
    ], axis=-1)

    vols = Volumes.create(lo=[[-1.0, -1.0, -1.0]], hi=[[1.0, 1.0, 1.0]],
                          texels=field[None], transfer=transfer[None],
                          device=dev)
    scene = Scene.create(volumes=vols, device=dev)
    cam = Pinhole.create(eye=(2.2, 1.6, 2.4), center=(0.0, 0.0, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=np.deg2rad(45.0),
                         aspect=1.0, device=dev)
    return scene, cam


def multi_volume_scene(resolution: int = 48, n_volumes: int = 3,
                       device="cuda"):
    """``n_volumes`` blobs in a row along +x, in non-overlapping boxes, each
    with its own transfer ramp (red, green, blue in turn); the camera looks
    down the row, so rays cross several volumes and the compositing order
    matters.  Returns (scene, camera)."""
    dev = resolve_device(device)
    _, _, _, r = _grid(resolution)
    t = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    ramps = [
        np.stack([np.ones_like(t) * 0.9, 0.2 + 0.3 * t, 0.1 * t,
                  np.where(t < 0.1, 0.0, 0.8 * t)], axis=-1),
        np.stack([0.1 * t, 0.9 * np.ones_like(t), 0.3 * t,
                  np.where(t < 0.1, 0.0, 0.8 * t)], axis=-1),
        np.stack([0.2 * t, 0.3 * t, 0.9 * np.ones_like(t),
                  np.where(t < 0.1, 0.0, 0.8 * t)], axis=-1),
    ]
    fields, transfers, los, his = [], [], [], []
    for i in range(n_volumes):
        blob = np.exp(-((r - 0.15 * (i + 1)) / 0.3) ** 2)
        fields.append(np.clip(blob, 0.0, 1.0).astype(np.float32))
        transfers.append(ramps[i % len(ramps)])
        cx = 2.4 * i
        los.append([cx - 1.0, -1.0, -1.0])
        his.append([cx + 1.0, 1.0, 1.0])

    vols = Volumes.create(lo=los, hi=his, texels=np.stack(fields),
                          transfer=np.stack(transfers), device=dev)
    scene = Scene.create(volumes=vols, device=dev)
    mid = 1.2 * (n_volumes - 1)
    cam = Pinhole.create(eye=(-3.2, 1.2, 4.5), center=(mid, 0.0, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=np.deg2rad(50.0),
                         aspect=1.0, device=dev)
    return scene, cam
