"""Core types: Ray, HitRecord, ResultRecord, AABB (port of core/types.py).

Plain dataclasses of tensors take the place of the JAX pytrees; every field
keeps the reference's SoA layout with arbitrary leading batch dimensions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.device import resolve_device

# numeric_limits<float>::max(), the "no hit yet" distance, written as the
# exact f32 value (torch refuses to narrow the decimal 3.4028235e38)
FLT_MAX = 3.4028234663852886e38


@dataclass
class Ray:
    """Ray batch: ``ori``/``dir`` have shape (..., 3)."""

    ori: Any
    dir: Any

    def at(self, t):
        return self.ori + self.dir * t[..., None]

    @property
    def batch_shape(self):
        return tuple(self.ori.shape[:-1])


@dataclass
class HitRecord:
    """Ray/primitive hit record; every field has the ray batch shape."""

    hit: Any       # bool
    t: Any         # f32
    prim_id: Any   # i32
    geom_id: Any   # i32
    u: Any         # f32 barycentric
    v: Any         # f32 barycentric

    @staticmethod
    def none(batch_shape, device) -> "HitRecord":
        bs = tuple(batch_shape)
        return HitRecord(
            hit=torch.zeros(bs, dtype=torch.bool, device=device),
            t=torch.full(bs, FLT_MAX, dtype=torch.float32, device=device),
            prim_id=torch.zeros(bs, dtype=torch.int32, device=device),
            geom_id=torch.zeros(bs, dtype=torch.int32, device=device),
            u=torch.zeros(bs, dtype=torch.float32, device=device),
            v=torch.zeros(bs, dtype=torch.float32, device=device),
        )

    def isect_pos(self, ray: Ray):
        return ray.at(self.t)


def is_closer(query: HitRecord, reference_t, max_t=None):
    """query.hit && query.t >= 0 && query.t < reference_t [&& t < max_t]."""
    closer = query.hit & (query.t >= 0.0) & (query.t < reference_t)
    if max_t is not None:
        closer = closer & (query.t < max_t)
    return closer


def update_if(dst: HitRecord, src: HitRecord, cond) -> HitRecord:
    """Masked hit-record update."""
    def sel(a, b):
        return torch.where(cond, a, b)

    return HitRecord(
        hit=dst.hit | cond,
        t=sel(src.t, dst.t),
        prim_id=sel(src.prim_id, dst.prim_id),
        geom_id=sel(src.geom_id, dst.geom_id),
        u=sel(src.u, dst.u),
        v=sel(src.v, dst.v),
    )


@dataclass
class ResultRecord:
    """Per-pixel kernel result."""

    color: Any      # (..., 4) RGBA
    hit: Any        # (...,) bool
    depth: Any      # (...,) f32


@dataclass
class AABB:
    """Axis-aligned box; lo/hi (..., 3)."""

    lo: Any
    hi: Any

    @staticmethod
    def empty(batch_shape=(), device="cuda") -> "AABB":
        dev = resolve_device(device)
        shape = tuple(batch_shape) + (3,)
        return AABB(
            lo=torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev),
            hi=torch.full(shape, -FLT_MAX, dtype=torch.float32, device=dev))

    def insert(self, other: "AABB") -> "AABB":
        return AABB(torch.minimum(self.lo, other.lo),
                    torch.maximum(self.hi, other.hi))

    def center(self):
        return 0.5 * (self.lo + self.hi)

    def size(self):
        return self.hi - self.lo
