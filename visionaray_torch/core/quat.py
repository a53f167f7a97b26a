"""Quaternion math for the camera manipulators (port of core/quat.py).

Semantics of the reference's math/quaternion.h and
math/detail/quaternion.inl:

- storage order (w, x, y, z);
- ``rotation_from_to(src, dst) = (dot(nf, nt), cross(nf, nt))``, the
  Shoemake arcball construction: it encodes twice the angle between the
  vectors, which is what arcball dragging wants (path independence);
- ``rotation_axis_angle`` in half-angle form;
- ``to_matrix4``: the 4x4 rotation matrix.

Quaternions are (..., 4) float32 tensors.
"""

from __future__ import annotations

import torch

from visionaray_torch.core.vecmath import cross, dot, normalize


def _f32(x, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def quat(w, x, y, z):
    w, x, y, z = torch.broadcast_tensors(*[_f32(c) for c in (w, x, y, z)])
    return torch.stack([w, x, y, z], dim=-1)


def identity(device=None):
    """quat::identity()."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=device)


def from_wxyz(w, v):
    """From a scalar part and a (..., 3) vector part."""
    v = _f32(v)
    return torch.cat([_f32(w, v)[..., None], v], dim=-1)


def rotation_from_to(src, dst):
    """The great-circle rotation taking ``src`` toward ``dst``, as the
    reference builds it: twice the angle between them, unit norm."""
    nf = normalize(_f32(src))
    nt = normalize(_f32(dst))
    return from_wxyz(dot(nf, nt), cross(nf, nt))


def rotation_axis_angle(axis, angle):
    """Half-angle quaternion of a rotation by ``angle`` about ``axis``."""
    axis = _f32(axis)
    angle = _f32(angle, axis)
    s = torch.sin(0.5 * angle) / torch.linalg.norm(axis, dim=-1)
    c = torch.cos(0.5 * angle)
    return from_wxyz(c, s[..., None] * axis)


def mul(p, q):
    """Hamilton product p * q."""
    pw, px, py, pz = (p[..., i] for i in range(4))
    qw, qx, qy, qz = (q[..., i] for i in range(4))
    return quat(
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw)


def conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=torch.float32,
                            device=q.device)


def norm(q):
    return torch.linalg.norm(q, dim=-1)


def normalize_quat(q):
    return q / torch.clamp_min(norm(q)[..., None], 1e-20)


def rotation_angle(q):
    """2 acos(w)."""
    return 2.0 * torch.arccos(torch.clip(q[..., 0], -1.0, 1.0))


def rotation_axis(q):
    """normalize(x, y, z)."""
    return normalize(q[..., 1:])


def to_matrix4(q):
    """Unit quaternion to a 4x4 rotation matrix, element for element the
    reference's (the 2 (ww + xx) - 1 diagonal form), applied as ``m @ v``
    to column vectors, as ``Pinhole.view_matrix``."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, xy, xz, xw = x * x, x * y, x * z, x * w
    yy, yz, yw = y * y, y * z, y * w
    zz, zw = z * z, z * w
    ww = w * w
    m = torch.zeros(tuple(q.shape[:-1]) + (4, 4), dtype=torch.float32,
                    device=q.device)
    m[..., 0, :3] = torch.stack([2 * (ww + xx) - 1, 2 * (xy - zw),
                                 2 * (xz + yw)], -1)
    m[..., 1, :3] = torch.stack([2 * (xy + zw), 2 * (ww + yy) - 1,
                                 2 * (yz - xw)], -1)
    m[..., 2, :3] = torch.stack([2 * (xz - yw), 2 * (yz + xw),
                                 2 * (ww + zz) - 1], -1)
    m[..., 3, 3] = 1.0
    return m


def rotate_vec(q, v):
    """Rotate (..., 3) vectors by the unit quaternion q."""
    u = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)
