"""Morton codes, triangle AABBs and bottom-up refit (port of the parts of
ops/lbvh.py the ClusterBVH build uses; build_radix_tree waits, see
ROADMAP).  Morton codes are uint32 values held in int64 tensors."""

from __future__ import annotations

import torch

from visionaray_torch.device import take


def _expand_bits(v):
    """Spread 10 bits to every 3rd position (int64 lanes never wrap here:
    v < 2^10 and every mask keeps the value below 2^32)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(p):
    """30-bit morton code of points p in [0,1)^3; (..., 3) -> int64."""
    q = torch.clamp(p * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))


def triangle_aabbs(v1, e1, e2):
    p0 = v1
    p1 = v1 + e1
    p2 = v1 + e2
    lo = torch.minimum(torch.minimum(p0, p1), p2)
    hi = torch.maximum(torch.maximum(p0, p1), p2)
    return lo, hi


def refit(left, right, leaf_lo, leaf_hi, max_iters: int = 64):
    """Bottom-up AABB fit by fixpoint sweeps over the unified node layout
    (internal [0, N-1), leaves [N-1, 2N-1)); returns (lo, hi) of all nodes.
    One host sync per sweep for the convergence test."""
    n = leaf_lo.shape[0]
    if n == 1:
        return leaf_lo, leaf_hi
    big = 3.4e38
    lo = torch.cat([torch.full((n - 1, 3), big, dtype=leaf_lo.dtype,
                               device=leaf_lo.device), leaf_lo], dim=0)
    hi = torch.cat([torch.full((n - 1, 3), -big, dtype=leaf_hi.dtype,
                               device=leaf_hi.device), leaf_hi], dim=0)
    for _ in range(max_iters):
        new_int_lo = torch.minimum(take(lo, left), take(lo, right))
        new_int_hi = torch.maximum(take(hi, left), take(hi, right))
        changed = bool(((new_int_lo != lo[: n - 1]).any()
                        | (new_int_hi != hi[: n - 1]).any()).item())
        lo = torch.cat([new_int_lo, lo[n - 1:]], dim=0)
        hi = torch.cat([new_int_hi, hi[n - 1:]], dim=0)
        if not changed:
            break
    return lo, hi
