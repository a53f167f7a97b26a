"""Vector math over (..., 3) tensors (port of core/vecmath.py).

Dot products are written out left to right, (a0*b0 + a1*b1) + a2*b2, so the
rounding does not depend on a reduction kernel's order.
"""

from __future__ import annotations

import torch


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    a0, b0 = torch.broadcast_tensors(a0, b0)
    a1, b1 = torch.broadcast_tensors(a1, b1)
    a2, b2 = torch.broadcast_tensors(a2, b2)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    """v * rsqrt(dot(v, v)); the 0-vector gives inf/nan like the reference."""
    return v * torch.rsqrt(dot(v, v))[..., None]


def safe_normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), eps))[..., None]


def reflect(i, n):
    """2*dot(n, i)*n - i, with ``i`` pointing away from the surface."""
    return 2.0 * dot(n, i)[..., None] * n - i


def refract(i, n, eta):
    """Refraction of ``i`` (pointing away from the surface) about n with
    ratio eta; the 0-vector on total internal reflection."""
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tdir = (eta * cosi - torch.sqrt(torch.clamp_min(k, 0.0)))[..., None] * n \
        - eta * i
    return torch.where((k < 0.0)[..., None], torch.zeros_like(i), tdir)


def faceforward(n, i, nref):
    """select(dot(nref, i) < 0, -n, n)."""
    return torch.where((dot(nref, i) < 0.0)[..., None], -n, n)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def vec3(x, y, z, dtype=torch.float32, device=None):
    return torch.tensor([x, y, z], dtype=dtype, device=device)


def vec4(x, y, z, w, dtype=torch.float32, device=None):
    return torch.tensor([x, y, z, w], dtype=dtype, device=device)


def orthonormal_basis(w):
    """(u, v) completing w to an ONB, the reference's BRDF sampling frame:

        v = |w.x|>|w.y| ? normalize((-w.z, 0, w.x)) : normalize((0, w.z, -w.y))
        u = cross(v, w)
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    v1 = torch.stack([-wz, zeros, wx], dim=-1)
    v2 = torch.stack([zeros, wz, -wy], dim=-1)
    v = torch.where((torch.abs(wx) > torch.abs(wy))[..., None], v1, v2)
    v = normalize(v)
    u = cross(v, w)
    return u, v


def mat4_apply(m, v):
    """Row vectors ``v`` (..., 4) times ``m.T`` for a 4x4 ``m``, written
    out as f32 products and sums: no matmul, so no reduced-precision
    (TF32) path whatever the global matmul settings are."""
    return (v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1]
            + v[..., 2:3] * m[:, 2] + v[..., 3:4] * m[:, 3])


def mat4_mul(a, b):
    """``a @ b`` of two 4x4 matrices, as ``mat4_apply``."""
    return mat4_apply(b.transpose(0, 1), a)


def mat4_inv(m):
    """Inverse of a 4x4 matrix, solved in f64 and rounded to f32 (the GL
    projection of a 1e6 near/far ratio is too ill-conditioned for an f32
    or TF32 solve)."""
    return torch.linalg.inv(m.to(torch.float64)).to(m.dtype)


def transform_point(m, p):
    """Apply a 4x4 matrix to point(s) (..., 3) with the perspective
    divide."""
    r = mat4_apply(m, torch.cat([p, torch.ones_like(p[..., :1])], dim=-1))
    return r[..., :3] / r[..., 3:4]


def transform_vector(m, v):
    """Apply the linear part of a 4x4 matrix to vector(s) (..., 3)."""
    return (v[..., 0:1] * m[:3, 0] + v[..., 1:2] * m[:3, 1]
            + v[..., 2:3] * m[:3, 2])
