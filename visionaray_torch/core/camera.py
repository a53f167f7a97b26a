"""Cameras and primary rays (port of core/camera.py): Pinhole, MatrixCamera,
project and unproject.

Pixel convention is OpenGL-style: x to the right, y up (row 0 is the bottom
of the image).  Every 4x4 product is written out in f32 products and sums
(``vecmath.mat4_apply``) and every inverse is solved in f64, so neither
depends on the process's matmul precision (TF32 on the card): at reduced
precision the GL projection's clip->world products put every ray of the
viewer's default camera on the ground plane.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.core.types import Ray
from visionaray_torch.core.vecmath import (
    cross, dot, length, mat4_apply, mat4_inv, mat4_mul, normalize,
)
from visionaray_torch.device import resolve_device


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _pixel_ndc(x, y, width, height, jitter):
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if jitter is not None:
        x = x + jitter[..., 0]
        y = y + jitter[..., 1]
    return 2.0 * (x + 0.5) / width - 1.0, 2.0 * (y + 0.5) / height - 1.0


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
        return Pinhole(_f32(eye, dev), _f32(center, dev), _f32(up, dev),
                       _f32(fovy, dev), _f32(aspect, dev), _f32(z_near, dev),
                       _f32(z_far, dev))

    @property
    def device(self) -> torch.device:
        return self.eye.device

    def look_at(self, eye, center, up=(0.0, 1.0, 0.0)) -> "Pinhole":
        dev = self.device
        return dataclasses.replace(self, eye=_f32(eye, dev),
                                   center=_f32(center, dev),
                                   up=_f32(up, dev))

    def perspective(self, fovy, aspect, z_near=0.001,
                    z_far=1000.0) -> "Pinhole":
        dev = self.device
        return dataclasses.replace(self, fovy=_f32(fovy, dev),
                                   aspect=_f32(aspect, dev),
                                   z_near=_f32(z_near, dev),
                                   z_far=_f32(z_far, dev))

    def view_all(self, bbox_lo, bbox_hi, up=(0.0, 1.0, 0.0)) -> "Pinhole":
        """Frame a bounding box."""
        dev = self.device
        lo = _f32(bbox_lo, dev)
        hi = _f32(bbox_hi, dev)
        r = length(hi - lo) * 0.5
        c = 0.5 * (lo + hi)
        eye = c + _f32((0.0, 0.0, 1.0), dev) * (r + r / torch.tan(self.fovy))
        return self.look_at(eye, c, up)

    @property
    def distance(self):
        return length(self.eye - self.center)

    def _frame(self):
        f = normalize(self.eye - self.center)
        s = normalize(cross(self.up, f))
        return f, s, cross(f, s)

    def basis(self):
        """(cam_u, cam_v, cam_w) image-plane basis."""
        f, s, u = self._frame()
        t = torch.tan(self.fovy / 2.0)
        cam_u = s * t * self.aspect
        cam_v = u * t
        cam_w = -f
        return cam_u, cam_v, cam_w

    def view_matrix(self):
        """Row-vector-on-right 4x4 view matrix."""
        f, s, u = self._frame()
        zero = torch.zeros_like(self.fovy)
        rows = [torch.cat([a, -dot(self.eye, a)[None]]) for a in (s, u, f)]
        rows.append(torch.stack([zero, zero, zero, torch.ones_like(zero)]))
        return torch.stack(rows)

    def proj_matrix(self):
        """GL-style perspective projection."""
        f = 1.0 / torch.tan(self.fovy * 0.5)
        zn, zf = self.z_near, self.z_far
        z = torch.zeros_like(f)
        return torch.stack([
            torch.stack([f / self.aspect, z, z, z]),
            torch.stack([z, f, z, z]),
            torch.stack([z, z, (zf + zn) / (zn - zf),
                         (2.0 * zf * zn) / (zn - zf)]),
            torch.stack([z, z, -torch.ones_like(z), z])])

    def primary_rays(self, x, y, width, height, jitter=None) -> Ray:
        """Primary rays through integer pixels (x, y) plus optional (..., 2)
        jitter in [-0.5, 0.5); the +0.5 pixel-center offset is applied
        here."""
        cam_u, cam_v, cam_w = self.basis()
        u, v = _pixel_ndc(x, y, width, height, jitter)
        d = normalize(cam_u * u[..., None] + cam_v * v[..., None] + cam_w)
        o = self.eye.expand(d.shape)
        return Ray(ori=o, dir=d)


@dataclass
class MatrixCamera:
    """Camera defined by view + proj matrices (4x4 each)."""

    view: Any
    proj: Any

    @staticmethod
    def from_pinhole(cam: Pinhole) -> "MatrixCamera":
        return MatrixCamera(view=cam.view_matrix(), proj=cam.proj_matrix())

    def primary_rays(self, x, y, width, height, jitter=None) -> Ray:
        """Rays from the near plane through each pixel: clip-space points
        at z = -1 and z = 1 taken to world space by inv(view) inv(proj)."""
        m = mat4_mul(mat4_inv(self.view), mat4_inv(self.proj))
        u, v = _pixel_ndc(x, y, width, height, jitter)
        ones = torch.ones_like(u)
        o_h = mat4_apply(m, torch.stack([u, v, -ones, ones], dim=-1))
        d_h = mat4_apply(m, torch.stack([u, v, ones, ones], dim=-1))
        ori = o_h[..., :3] / o_h[..., 3:4]
        # the homogeneous difference d*o_w - o*d_w: the same direction as
        # far/far_w - ori up to the positive scale o_w*d_w, without dividing
        # by the far point's w, which underflows in f32 at large
        # z_far/z_near ratios (NaN rays at the viewer's 0.001/1000)
        dir_h = d_h[..., :3] * o_h[..., 3:4] - o_h[..., :3] * d_h[..., 3:4]
        # the sign of each factor apart: o_w*d_w itself can underflow to 0
        sgn = torch.sign(o_h[..., 3:4]) * torch.sign(d_h[..., 3:4])
        sgn = torch.where(sgn == 0, 1.0, sgn)
        return Ray(ori=ori, dir=normalize(dir_h * sgn))


def project(p, view, proj, viewport):
    """GL-style project; viewport = (x, y, w, h).  Returns window coords
    (..., 3) with z in [0, 1]."""
    clip = mat4_apply(mat4_mul(proj, view),
                      torch.cat([p, torch.ones_like(p[..., :1])], dim=-1))
    ndc = clip[..., :3] / clip[..., 3:4]
    x, y, w, h = viewport
    return torch.stack([x + w * (ndc[..., 0] + 1.0) * 0.5,
                        y + h * (ndc[..., 1] + 1.0) * 0.5,
                        (ndc[..., 2] + 1.0) * 0.5], dim=-1)


def unproject(win, view, proj, viewport):
    """GL-style unproject, the inverse of ``project``."""
    x, y, w, h = viewport
    ndc = torch.stack([(win[..., 0] - x) / w * 2.0 - 1.0,
                       (win[..., 1] - y) / h * 2.0 - 1.0,
                       win[..., 2] * 2.0 - 1.0], dim=-1)
    inv = mat4_inv(mat4_mul(proj, view))
    obj = mat4_apply(inv, torch.cat([ndc, torch.ones_like(ndc[..., :1])],
                                    dim=-1))
    return obj[..., :3] / obj[..., 3:4]
