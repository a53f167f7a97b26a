"""The chip's peaks and the LBVH walk's least work, from a cell's shapes
alone (never from the kernel's own counters), so the bound reads the same
work whatever implements the walk.

Per iteration the walk traces R = W * H * spp * bounces * 2 rays (a
closest-hit and a shadow ray a bounce).  Bytes: each ray read once
(origin, direction, t range: 32 B) and its hit written once (t, prim, u,
v: 16 B); each of the N triangles' three vertices (36 B) and a binary
tree of 2N - 1 two-corner nodes (24 B) read once.  Operations: each ray
one root-to-leaf descent of ceil(log2 N) levels, two 20-operation box
tests a level, and one 40-operation triangle test (``chip_smoke.py``'s
weights).  The bound is the larger of bytes over the bandwidth and
operations over the float32 rate.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (data sheet, 700 W): HBM3 bandwidth, float32 outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
FLOP_BOX, FLOP_TRI = 20, 40
RAY_BYTES, HIT_BYTES, TRI_BYTES, NODE_BYTES = 32, 16, 36, 24


def walk_bound_s(shapes: dict) -> float:
    """The least seconds one iteration's walks could take on the chip."""
    n = shapes["triangles"]
    rays = (shapes["width"] * shapes["height"] * shapes["spp"]
            * shapes["bounces"] * 2)
    nbytes = (rays * (RAY_BYTES + HIT_BYTES) + n * TRI_BYTES
              + (2 * n - 1) * NODE_BYTES)
    ops = rays * (math.ceil(math.log2(n)) * 2 * FLOP_BOX + FLOP_TRI)
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)
