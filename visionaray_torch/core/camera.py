"""Pinhole camera and primary rays (port of core/camera.py::Pinhole).

Pixel convention is OpenGL-style: x to the right, y up (row 0 is the bottom
of the image).  MatrixCamera, project and unproject are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.core.types import Ray
from visionaray_torch.core.vecmath import cross, normalize
from visionaray_torch.device import resolve_device


@dataclass
class Pinhole:
    eye: Any
    center: Any
    up: Any
    fovy: Any    # radians, full angle
    aspect: Any
    z_near: Any
    z_far: Any

    @staticmethod
    def create(eye, center, up=(0.0, 1.0, 0.0), fovy=math.pi / 4,
               aspect=1.0, z_near=0.001, z_far=1000.0,
               device="cuda") -> "Pinhole":
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        return Pinhole(f32(eye), f32(center), f32(up), f32(fovy), f32(aspect),
                       f32(z_near), f32(z_far))

    def basis(self):
        """(cam_u, cam_v, cam_w) image-plane basis."""
        f = normalize(self.eye - self.center)
        s = normalize(cross(self.up, f))
        u = cross(f, s)
        t = torch.tan(self.fovy / 2.0)
        cam_u = s * t * self.aspect
        cam_v = u * t
        cam_w = -f
        return cam_u, cam_v, cam_w

    def primary_rays(self, x, y, width, height, jitter=None) -> Ray:
        """Primary rays through integer pixels (x, y) plus optional (..., 2)
        jitter in [-0.5, 0.5); the +0.5 pixel-center offset is applied
        here."""
        cam_u, cam_v, cam_w = self.basis()
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        if jitter is not None:
            x = x + jitter[..., 0]
            y = y + jitter[..., 1]
        u = 2.0 * (x + 0.5) / width - 1.0
        v = 2.0 * (y + 0.5) / height - 1.0
        d = normalize(cam_u * u[..., None] + cam_v * v[..., None] + cam_w)
        o = self.eye.expand(d.shape)
        return Ray(ori=o, dir=d)
