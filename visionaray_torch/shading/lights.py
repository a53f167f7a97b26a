"""Point, spot and area lights as SoA dataclasses (port of
shading/lights.py)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.core.vecmath import cross, dot, length, normalize
from visionaray_torch.device import resolve_device


def light_groups(lights):
    """Normalize a lights field (single group / tuple / list) to a tuple."""
    if lights is None:
        return ()
    if isinstance(lights, (tuple, list)):
        return tuple(lights)
    return (lights,)


def _f32(x, dev, shape=None):
    a = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return a if shape is None else a.expand(shape).contiguous()


@dataclass
class PointLights:
    """Point lights: cl*kl / (c + l*d + q*d^2)."""

    position: Any     # (L, 3)
    cl: Any           # (L, 3)
    kl: Any           # (L,)
    attenuation: Any  # (L, 3) constant/linear/quadratic

    @staticmethod
    def create(position, cl=(1.0, 1.0, 1.0), kl=1.0,
               attenuation=(1.0, 0.0, 0.0), device="cuda") -> "PointLights":
        dev = resolve_device(device)
        position = _f32(position, dev).reshape(-1, 3)
        L = position.shape[0]
        return PointLights(position, _f32(cl, dev, (L, 3)),
                           _f32(kl, dev, (L,)),
                           _f32(attenuation, dev, (L, 3)))

    @staticmethod
    def none(device="cuda") -> "PointLights":
        dev = resolve_device(device)
        z = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        return PointLights(z, z, torch.zeros((0,), dtype=torch.float32,
                                             device=dev), z)

    @property
    def num_lights(self):
        return self.position.shape[0]

    def intensity(self, light_idx, pos):
        p = self.position[light_idx]
        att = self.attenuation[light_idx]
        d = length(p - pos)
        denom = att[0] + att[1] * d + att[2] * d * d
        scale = self.kl[light_idx] / denom
        return self.cl[light_idx] * scale[..., None]

    def sample(self, light_idx, u1=None, u2=None):
        """A point light samples its own position."""
        return self.position[light_idx]


@dataclass
class SpotLights:
    """Spot lights: cl*kl * attenuation * spot, spot = dot(dir,
    normalize(pos - light_pos)) above cos_cutoff, raised to exponent."""

    position: Any     # (L, 3)
    cl: Any           # (L, 3)
    kl: Any           # (L,)
    attenuation: Any  # (L, 3)
    direction: Any    # (L, 3) normalized spot axis
    cos_cutoff: Any   # (L,)
    exponent: Any     # (L,)

    @staticmethod
    def create(position, direction, cutoff_deg=30.0, exponent=1.0,
               cl=(1.0, 1.0, 1.0), kl=1.0, attenuation=(1.0, 0.0, 0.0),
               device="cuda") -> "SpotLights":
        dev = resolve_device(device)
        position = _f32(position, dev).reshape(-1, 3)
        L = position.shape[0]
        direction = normalize(_f32(direction, dev).reshape(-1, 3))
        cos_c = torch.tensor(math.cos(math.radians(cutoff_deg)),
                             dtype=torch.float32, device=dev)
        return SpotLights(
            position=position, cl=_f32(cl, dev, (L, 3)),
            kl=_f32(kl, dev, (L,)), attenuation=_f32(attenuation, dev, (L, 3)),
            direction=direction.expand(L, 3).contiguous(),
            cos_cutoff=cos_c.expand(L).contiguous(),
            exponent=_f32(exponent, dev, (L,)))

    @property
    def num_lights(self):
        return self.position.shape[0]

    def intensity(self, light_idx, pos):
        p = self.position[light_idx]
        att = self.attenuation[light_idx]
        light_dir = p - pos
        d = length(light_dir)
        a = self.kl[light_idx] / (att[0] + att[1] * d + att[2] * d * d)
        spot = dot(self.direction[light_idx].expand(pos.shape),
                   normalize(-light_dir))
        spot = torch.where(spot > self.cos_cutoff[light_idx],
                           torch.pow(spot, self.exponent[light_idx]), 0.0)
        return self.cl[light_idx] * (a * spot)[..., None]

    def sample(self, light_idx, u1=None, u2=None):
        """A spot light samples its own position."""
        return self.position[light_idx]


@dataclass
class AreaLights:
    """Triangle area lights in v1/e1/e2 form (a rectangle is two)."""

    v1: Any   # (L, 3)
    e1: Any   # (L, 3)
    e2: Any   # (L, 3)
    cl: Any   # (L, 3)
    kl: Any   # (L,)

    @staticmethod
    def create(v1, e1, e2, cl=(1.0, 1.0, 1.0), kl=1.0,
               device="cuda") -> "AreaLights":
        dev = resolve_device(device)
        v1 = _f32(v1, dev).reshape(-1, 3)
        L = v1.shape[0]
        return AreaLights(v1, _f32(e1, dev, (L, 3)), _f32(e2, dev, (L, 3)),
                          _f32(cl, dev, (L, 3)), _f32(kl, dev, (L,)))

    @staticmethod
    def rect(corner, edge1, edge2, cl=(1.0, 1.0, 1.0), kl=1.0,
             device="cuda") -> "AreaLights":
        dev = resolve_device(device)
        c = _f32(corner, dev).reshape(3)
        a = _f32(edge1, dev).reshape(3)
        b = _f32(edge2, dev).reshape(3)
        return AreaLights.create(torch.stack([c, c + a + b]),
                                 torch.stack([a, -a]), torch.stack([b, -b]),
                                 cl=cl, kl=kl, device=dev)

    @property
    def num_lights(self):
        return self.v1.shape[0]

    @property
    def position(self):
        """Centroids, so that the kernels that treat every light as a point
        light (simple) can loop over area lights too."""
        return self.v1 + (self.e1 + self.e2) / 3.0

    def normal(self, light_idx):
        return normalize(cross(self.e1[light_idx], self.e2[light_idx]))

    def area(self, light_idx):
        return 0.5 * length(cross(self.e1[light_idx], self.e2[light_idx]))

    def intensity(self, light_idx, pos):
        """cl * kl (no distance attenuation; 1/r^2 is in the estimator)."""
        base = self.cl[light_idx] * self.kl[light_idx]
        return base.expand(tuple(pos.shape[:-1]) + (3,))

    def sample(self, light_idx, u1=None, u2=None):
        """Uniform position on the triangle for uniforms ``u1``, ``u2``
        (...,); without them, its centroid (``position``)."""
        if u1 is None:
            return self.position[light_idx]
        su = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
        b1 = 1.0 - su
        b2 = u2 * su
        return (self.v1[light_idx]
                + b1[..., None] * self.e1[light_idx]
                + b2[..., None] * self.e2[light_idx])
