"""LBVH: morton codes, Karras'12 radix-tree linking and bottom-up refit
(port of ops/lbvh.py), the flat ``BVH`` that the per-ray stack traversal
(ops/traversal.py) walks, and host-side introspection of a built tree.

Node layout (SoA): internal nodes occupy [0, L-1), leaves [L-1, 2L-1);
``left``/``right`` index the unified node array.  Morton codes are uint32
values held in int64 tensors.  The ClusterBVH radix build
(ops/cluster_bvh.py) shares the linking and the refit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from visionaray_torch.device import take


@dataclass
class BVH:
    """Flat SoA BVH over one primitive group (the JAX ``BVH`` pytree).

    Two leaf conventions share this container:
    - 1:1 (LBVH, plain SAH): ``leaf_first is None``; leaf slot s owns
      primitive ``prim_ids[s]``: L leaves, L prims.
    - generalized (SBVH, ops/sah.py:build_sbvh): leaf slot s covers
      ``prim_ids[leaf_first[s] : leaf_first[s] + leaf_count[s]]``; spatial
      splits may reference one primitive from several leaves, so
      ``len(prim_ids) >= num_leaves``.

    ``depth`` (edges from the root to the deepest leaf) is computed once at
    build: the traversal refuses a tree deeper than its stack.
    """

    node_lo: Any    # (2L-1, 3) f32
    node_hi: Any    # (2L-1, 3) f32
    left: Any       # (L-1,) i32 child node index
    right: Any      # (L-1,) i32
    parent: Any     # (2L-1,) i32 (root = -1)
    prim_ids: Any   # 1:1 -> (L,) i32; generalized -> (R,) i32 refs
    leaf_first: Any = None   # (L,) i32 or None (1:1 convention)
    leaf_count: Any = None   # (L,) i32 or None
    max_leaf_size: int = 1   # bound on leaf_count
    depth: Optional[int] = None

    def __post_init__(self):
        if self.depth is None:
            self.depth = tree_depth(self.left, self.right)

    @property
    def num_prims(self):
        return self.prim_ids.shape[0]

    @property
    def num_leaves(self):
        return (self.node_lo.shape[0] + 1) // 2

    @property
    def num_nodes(self):
        return self.node_lo.shape[0]


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


def clz32(x):
    """Leading zeros of 32-bit values held in an int64 tensor (0 -> 32),
    exact: a bit-length search over shifts, no float log2."""
    bits = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) != 0
        bits = bits + big.to(x.dtype) * s
        x = torch.where(big, x >> s, x)
    return 32 - (bits + (x != 0).to(x.dtype))


def _delta_fn(codes, idx):
    """delta(i, j): common-prefix length of keys i and j, with the sorted
    index as tiebreak for equal codes (adds 32 + clz(i ^ j)); out-of-range
    j -> -1 (Karras'12 section 4)."""
    n = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = take(codes, i) ^ take(codes, jc)
        d = clz32(x)
        d_eq = 32 + clz32(take(idx, i) ^ take(idx, jc))
        d = torch.where(x == 0, d_eq, d)
        return torch.where(valid, d, -1)

    return delta


def build_radix_tree(codes_sorted):
    """Karras'12 parallel radix-tree linking over sorted codes.

    Returns (left, right, parent) int64: left/right index the unified
    layout (internal [0, n-1), leaves [n-1, 2n-1)); parent covers all
    nodes, -1 at the root.  Every search runs the fixed iteration counts of
    the JAX build, so the links are equal to its links.
    """
    n = codes_sorted.shape[0]
    dev = codes_sorted.device
    if n == 1:
        return (torch.zeros((0,), dtype=torch.int64, device=dev),
                torch.zeros((0,), dtype=torch.int64, device=dev),
                torch.full((1,), -1, dtype=torch.int64, device=dev))
    codes = codes_sorted.to(torch.int64)
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    delta = _delta_fn(codes, idx)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)

    # upper bound of the range length: double while delta stays above
    n_doublings = max(2, int(math.ceil(math.log2(max(n, 2)))) + 1)
    lmax = torch.full_like(i, 2)
    for _ in range(n_doublings):
        cond = delta(i, i + lmax * d) > delta_min
        lmax = torch.where(cond, torch.clamp_max(lmax * 2, 2 * n), lmax)

    # binary search of the other end j = i + l*d
    length = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(n_doublings + 1):
        cond = (t >= 1) & (delta(i, i + (length + t) * d) > delta_min)
        length = torch.where(cond, length + t, length)
        t = t // 2
    j = i + length * d

    # binary search of the split position
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = (length + 1) // 2
    for _ in range(n_doublings + 1):
        cond = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(cond, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    leaf_base = n - 1
    left = torch.where(lo == gamma, leaf_base + gamma, gamma)
    right = torch.where(hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    parent = torch.full((2 * n - 1,), -1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i
    return left, right, parent


def tree_depth(left, right) -> int:
    """Edges from the root (node 0) to the deepest leaf of a tree in the
    unified layout; one host sync per level."""
    n_int = left.shape[0]
    depth = 0
    frontier = torch.zeros((1,), dtype=torch.int64, device=left.device)
    while True:
        inner = frontier[frontier < n_int]
        if inner.numel() == 0:
            return depth
        depth += 1
        frontier = torch.cat([take(left, inner), take(right, inner)])


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


def build_lbvh_from_aabbs(prim_lo, prim_hi) -> BVH:
    """Build an LBVH over primitive AABBs (any primitive type): morton
    codes of the centroids, a stable argsort (so ``prim_ids`` and the links
    equal JAX's), Karras linking, refit.  Runs on the AABBs' device."""
    prim_lo = prim_lo.detach().to(torch.float32)
    prim_hi = prim_hi.detach().to(torch.float32)
    centroid = 0.5 * (prim_lo + prim_hi)
    scene_lo = torch.amin(prim_lo, dim=0)
    scene_hi = torch.amax(prim_hi, dim=0)
    extent = torch.clamp_min(scene_hi - scene_lo, 1e-9)
    codes = morton3d((centroid - scene_lo) / extent)
    order = torch.argsort(codes, stable=True)
    left, right, parent = build_radix_tree(take(codes, order))
    node_lo, node_hi = refit(left, right, take(prim_lo, order),
                             take(prim_hi, order))
    i32 = torch.int32
    return BVH(node_lo=node_lo, node_hi=node_hi, left=left.to(i32),
               right=right.to(i32), parent=parent.to(i32),
               prim_ids=order.to(i32), depth=tree_depth(left, right))


def build_lbvh(mesh) -> BVH:
    """Build an LBVH over a TriangleMesh on the mesh's device."""
    v1, e1, e2 = mesh.corners()
    lo, hi = triangle_aabbs(v1, e1, e2)
    return build_lbvh_from_aabbs(lo, hi)


# ---------------------------------------------------------------------------
# Introspection and quality metrics: host code over fetched arrays.


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def sah_cost(bvh: BVH, ci: float = 1.2, ct: float = 1.0) -> float:
    """Surface-area-heuristic cost of the built tree (ci per primitive
    test; a generalized leaf pays ci per primitive it holds)."""
    lo = _np(bvh.node_lo)
    hi = _np(bvh.node_hi)
    ext = np.maximum(hi - lo, 0.0)
    area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                  + ext[:, 2] * ext[:, 0])
    nl = bvh.num_leaves
    root_area = max(float(area[0] if nl > 1 else area[-1]), 1e-30)
    internal = area[: nl - 1].sum() / root_area if nl > 1 else 0.0
    if bvh.leaf_count is None:
        leaves = area[nl - 1:].sum() / root_area
    else:
        cnt = _np(bvh.leaf_count).astype(np.float64)
        leaves = (area[nl - 1:] * cnt).sum() / root_area
    return float(ct * internal + ci * leaves)


def validate(bvh: BVH, prim_lo, prim_hi) -> dict:
    """Structural invariants: every prim in exactly one leaf; parent boxes
    contain their children; every non-root node has exactly one parent;
    leaf boxes are their prims' boxes."""
    n = bvh.num_prims
    left = _np(bvh.left)
    right = _np(bvh.right)
    lo = _np(bvh.node_lo)
    hi = _np(bvh.node_hi)
    prim_ids = _np(bvh.prim_ids)
    out = {"prims_permutation": bool(
        (np.sort(prim_ids) == np.arange(n)).all())}
    if n > 1:
        children = np.concatenate([left, right])
        out["each_node_one_parent"] = bool(
            (np.sort(children) == np.arange(1, 2 * n - 1)).all())
        out["parent_contains_children"] = bool(
            (lo[: n - 1] <= np.minimum(lo[left], lo[right]) + 1e-6).all()
            and (hi[: n - 1] >= np.maximum(hi[left], hi[right]) - 1e-6).all())
    plo = _np(prim_lo)[prim_ids]
    phi = _np(prim_hi)[prim_ids]
    out["leaves_match_prims"] = bool(
        np.allclose(lo[n - 1:], plo) and np.allclose(hi[n - 1:], phi))
    return out


def traverse_depth_first(bvh: BVH, visit, node: int = 0):
    """Depth-first walk calling ``visit(node_index, is_leaf)``, left child
    first."""
    left = _np(bvh.left)
    right = _np(bvh.right)
    n_internal = left.shape[0]
    stack = [int(node)]
    while stack:
        n = stack.pop()
        is_leaf = n >= n_internal
        visit(n, is_leaf)
        if not is_leaf:
            stack.append(int(right[n]))   # popped after the left child
            stack.append(int(left[n]))


def traverse_leaves(bvh: BVH, visit, node: int = 0):
    """Visit only the leaves, depth first."""
    traverse_depth_first(
        bvh, lambda n, is_leaf: visit(n) if is_leaf else None, node)


def traverse_parents(bvh: BVH, node: int, visit):
    """Walk the parent links from ``node`` up to the root."""
    parent = _np(bvh.parent)
    n = int(parent[node])
    while n >= 0:
        visit(n)
        n = int(parent[n])
