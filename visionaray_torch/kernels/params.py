"""Kernel parameters (port of kernels/params.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from visionaray_torch.ops.trace import TraceConfig


@dataclass
class KernelParams:
    """Scene + render options passed to every kernel."""

    scene: Any
    epsilon: Any        # f32 scalar tensor: self-intersection offset
    bg_color: Any       # (4,) RGBA
    ambient_color: Any  # (4,) RGBA
    num_bounces: int = 4
    hit_filter: Any = None
    # the traversal switches (the JAX package's VSNRAY_* variables)
    trace: TraceConfig = field(default_factory=TraceConfig)

    @staticmethod
    def create(scene, num_bounces=4, epsilon=1e-3,
               bg_color=(0.1, 0.4, 1.0, 1.0), ambient_color=None,
               hit_filter=None, trace=None) -> "KernelParams":
        if ambient_color is None:
            ambient_color = (0.0, 0.0, 0.0, 0.0)
        dev = scene.device

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        return KernelParams(scene=scene, epsilon=f32(epsilon),
                            bg_color=f32(bg_color),
                            ambient_color=f32(ambient_color),
                            num_bounces=num_bounces, hit_filter=hit_filter,
                            trace=TraceConfig() if trace is None else trace)
