"""Ray/primitive intersection (port of ops/intersect.py).

Broadcasting re-derivations of the reference's math: the slab test for
boxes, Moeller-Trumbore for triangles, stable quadratic for spheres,
planes.
"""

from __future__ import annotations

import torch

from visionaray_torch.core.vecmath import cross, dot


def intersect_aabb(ori, inv_dir, lo, hi):
    """Branchless slab test (reference math/intersect.h:54-70); returns
    (tnear, tfar, hit = tfar >= tnear), not clipped to t >= 0.  ``inv_dir``
    is 1/d unclamped, and min/max propagate NaN as jnp's do: a zero
    direction component with the origin on a box plane gives 0 * inf = NaN,
    and the box is missed."""
    t1 = (lo - ori) * inv_dir
    t2 = (hi - ori) * inv_dir
    tnear = torch.amax(torch.minimum(t1, t2), dim=-1)
    tfar = torch.amin(torch.maximum(t1, t2), dim=-1)
    return tnear, tfar, tfar >= tnear


def intersect_triangle(ori, dir, v1, e1, e2):
    """Moeller-Trumbore over v1/e1/e2 triangles; returns (t, u, v, hit).
    Where !hit, t = -1 and u = v = 0."""
    s1 = cross(dir, e2)
    div = dot(s1, e1)
    hit = div != 0.0
    inv_div = torch.where(hit, 1.0 / torch.where(hit, div, 1.0), 0.0)
    d = ori - v1
    b1 = dot(d, s1) * inv_div
    hit = hit & (b1 >= 0.0) & (b1 <= 1.0)
    s2 = cross(d, e1)
    b2 = dot(dir, s2) * inv_div
    hit = hit & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = dot(e2, s2) * inv_div
    t = torch.where(hit, t, -1.0)
    u = torch.where(hit, b1, 0.0)
    v = torch.where(hit, b2, 0.0)
    return t, u, v, hit


def intersect_sphere(ori, dir, center, radius):
    """Stable quadratic; returns (t, hit) with t = min(t1, t2)."""
    o = ori - center
    A = dot(dir, dir)
    B = 2.0 * dot(dir, o)
    C = dot(o, o) - radius * radius
    disc = B * B - 4.0 * A * C
    valid = disc >= 0.0
    root_disc = torch.sqrt(torch.where(valid, disc, 0.0))
    q = torch.where(B < 0.0, -0.5 * (B - root_disc), -0.5 * (B + root_disc))
    safe_q = torch.where(q != 0.0, q, 1.0)
    safe_A = torch.where(A != 0.0, A, 1.0)
    t1 = q / safe_A
    t2 = C / safe_q
    t = torch.where(valid, torch.minimum(t1, t2), -1.0)
    return t, valid


def intersect_plane(ori, dir, normal, offset):
    """Ray/plane dot(n, x) = offset; returns (t, hit)."""
    s = dot(normal, dir)
    hit = s != 0.0
    t = torch.where(hit, (offset - dot(normal, ori)) / torch.where(hit, s, 1.0),
                    -1.0)
    return t, hit
