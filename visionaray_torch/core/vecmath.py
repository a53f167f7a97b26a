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


def reflect(i, n):
    """2*dot(n, i)*n - i, with ``i`` pointing away from the surface."""
    return 2.0 * dot(n, i)[..., None] * n - i


def faceforward(n, i, nref):
    """select(dot(nref, i) < 0, -n, n)."""
    return torch.where((dot(nref, i) < 0.0)[..., None], -n, n)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


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
