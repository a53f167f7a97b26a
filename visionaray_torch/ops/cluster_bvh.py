"""Cluster BVH build (port of ops/pallas/cluster_bvh.py), same table layout.

Two builds, both with the unified node layout of the kernel:

- the kd build (``treelet_size`` T > 0): triangles kd-sorted into C = 2^L
  clusters of K; the top tree is a complete binary heap over the clusters,
  children of i at 2i+1 / 2i+2, treelet s (T consecutive clusters) the
  subtree at row (S-1)+s;
- the radix build (``treelet_size`` 0, or fewer than two treelets): prims
  morton-sorted into C = ceil(F/K) clusters, clusters sorted by their own
  codes, and a Karras'12 radix tree over them; the kernel reads the
  children from the kids columns.  C == 1 is a single leaf.

  nodes[n, c], c in 0..7 = [lo.x lo.y lo.z hi.x hi.y hi.z left right]
    internal nodes [0, C-1) with their children stored as float values,
    leaf of cluster c at row (C-1)+c
  tris (C, K//8, 128): 16-float records [v1 e1 e2 prim_id pad*6], 8 per
    128-float row; padding prims have e1 = e2 = 0 and never hit

Every sort is stable (jnp.argsort is), so equal keys -- the grid-quad
floors and walls of the sponza-class scene have many -- keep input order
and the tables come out equal to the JAX build's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.device import take
from visionaray_torch.ops.lbvh import (
    build_radix_tree, morton3d, refit, tree_depth, triangle_aabbs,
)


@dataclass
class ClusterBVH:
    nodes: Any               # (2C-1, 8) f32 node table
    tris: Any                # (C, K//8, 128) f32 triangle records
    num_clusters: int        # C
    cluster_size: int        # K
    treelet_size: int = 0    # T; 0 = single global tree
    num_treelets: int = 0    # S
    treelet_lo: Any = None   # (S, 3)
    treelet_hi: Any = None   # (S, 3)
    treelet_roots: Any = None  # (S,) i32 node rows of the treelet roots
    heap: bool = False       # children of i at 2i+1 / 2i+2
    half_boxes: bool = False  # records 0/1 cols 10..15: half-cluster AABBs
    depth: int = 0           # edges from the root to the deepest leaf

    def tri_records(self):
        """The packed table as (C, K, 16) records."""
        return self.tris.reshape(self.num_clusters, self.cluster_size, 16)


def _sorted_cluster_data(v1, e1, e2, K: int):
    """Morton-sort prims, group into K-clusters; returns (C, tri_cols,
    cl_lo, cl_hi, cl_codes) with clusters sorted by their own codes."""
    dev = v1.device
    F = v1.shape[0]
    lo, hi = triangle_aabbs(v1, e1, e2)
    centroid = 0.5 * (lo + hi)
    scene_lo = torch.amin(lo, dim=0)
    scene_hi = torch.amax(hi, dim=0)
    extent = torch.clamp_min(scene_hi - scene_lo, 1e-9)
    codes = morton3d((centroid - scene_lo) / extent)
    order = torch.argsort(codes, stable=True).to(torch.int32)

    C = -(-F // K)
    pad = C * K - F
    v1s, e1s, e2s = take(v1, order), take(e1, order), take(e2, order)
    prim_ids = order
    los, his = take(lo, order), take(hi, order)
    if pad:
        def padv(a, val):
            return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), val,
                                            dtype=a.dtype, device=dev)])
        v1s, e1s, e2s = padv(v1s, 0.0), padv(e1s, 0.0), padv(e2s, 0.0)
        prim_ids = padv(prim_ids, 0)
        los, his = padv(los, math.inf), padv(his, -math.inf)

    cl_lo = torch.amin(los.reshape(C, K, 3), dim=1)
    cl_hi = torch.amax(his.reshape(C, K, 3), dim=1)
    cl_lo = torch.where(torch.isfinite(cl_lo), cl_lo, 0.0)
    cl_hi = torch.where(torch.isfinite(cl_hi), cl_hi, 0.0)

    cl_codes = morton3d((0.5 * (cl_lo + cl_hi) - scene_lo) / extent)
    cl_order = torch.argsort(cl_codes, stable=True)

    assert K % 8 == 0, "cluster_size must be a multiple of 8"
    tri_cols = torch.cat([
        v1s.reshape(C, K, 3), e1s.reshape(C, K, 3), e2s.reshape(C, K, 3),
        prim_ids.reshape(C, K, 1).to(torch.float32),
        torch.zeros((C, K, 6), dtype=torch.float32, device=dev),
    ], dim=-1)
    return (C, take(tri_cols, cl_order), take(cl_lo, cl_order),
            take(cl_hi, cl_order), take(cl_codes, cl_order))


def pick_cluster_size(num_prims: int) -> int:
    """The JAX build's automatic K: the smallest multiple of 8 whose node
    table (28 B a node) fits its 750,000-byte budget, at least 32."""
    k = 8
    while (2 * -(-num_prims // k) - 1) * 28 > 750_000:
        k += 8
    return max(k, 32)


def build_cluster_bvh(mesh, cluster_size: int = 0, treelet_size: int = 0,
                      sah_axis: bool = True) -> ClusterBVH:
    """Build the ClusterBVH on the mesh's device: the kd heap with treelets
    of ``treelet_size`` T clusters (the main path's K=32, T=128), or with
    T = 0 one radix tree.  ``cluster_size`` 0 picks K automatically."""
    with torch.no_grad():
        v1, e1, e2 = mesh.corners()
    K = cluster_size or pick_cluster_size(v1.shape[0])
    if v1.shape[0] >= (1 << 24):
        raise ValueError(
            f"ClusterBVH holds prim ids as f32 (exact < 2^24); got "
            f"{v1.shape[0]} prims")
    if treelet_size > 0:
        return _build_kd_tree(v1, e1, e2, K, treelet_size, sah_axis=sah_axis)
    return _build_single_tree(*_sorted_cluster_data(v1, e1, e2, K), K=K)


def _build_single_tree(C, tri_cols, cl_lo, cl_hi, cl_codes, K: int):
    """One radix tree over the code-sorted clusters (JAX
    cluster_bvh.py:209-227); the kids ride nodes[:, 6:8] as float values,
    and C == 1 is a (1, 8) table with zero kids."""
    dev = cl_lo.device
    left, right, _ = build_radix_tree(cl_codes)
    node_lo, node_hi = refit(left, right, cl_lo, cl_hi)
    zeros = torch.zeros((C,), dtype=torch.float32, device=dev)
    if C > 1:
        lf = torch.cat([left.to(torch.float32), zeros])
        rf = torch.cat([right.to(torch.float32), zeros])
    else:
        lf = rf = zeros
    nodes = torch.stack([
        node_lo[:, 0], node_lo[:, 1], node_lo[:, 2],
        node_hi[:, 0], node_hi[:, 1], node_hi[:, 2], lf, rf], dim=1)
    return ClusterBVH(nodes=nodes.contiguous(),
                      tris=tri_cols.reshape(C, K // 8, 128).contiguous(),
                      num_clusters=int(C), cluster_size=K,
                      depth=tree_depth(left, right))


def _half_sa(lo_h, hi_h):
    d = torch.clamp_min(torch.amax(hi_h, dim=1) - torch.amin(lo_h, dim=1),
                        0.0)
    return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
            + d[..., 2] * d[..., 0])


def _kd_sort(cent, levels: int, tri_lo=None, tri_hi=None):
    """Balanced kd permutation: recursively median-split equal segments.

    With ``tri_lo``/``tri_hi`` each segment tries the median split on all
    three axes and keeps the one with the least summed child surface area
    (ties to the lower axis); without them, the longest centroid extent.
    Padding entries carry centroid 3e38 (and +inf/-inf boxes) so they sink
    to the tail.  Returns the (n,) int64 permutation.
    """
    n = cent.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=cent.device)
    for lvl in range(levels):
        n_seg = 1 << lvl
        seg = n // n_seg
        c = take(cent, perm).reshape(n_seg, seg, 3)
        if tri_lo is not None and seg >= 2:
            lo_p = take(tri_lo, perm).reshape(n_seg, seg, 3)
            hi_p = take(tri_hi, perm).reshape(n_seg, seg, 3)
            half = seg // 2
            orders, costs = [], []
            for a in range(3):
                order_a = torch.argsort(c[..., a], dim=1, stable=True)
                idx3 = order_a[..., None].expand(n_seg, seg, 3)
                lo_s = torch.gather(lo_p, 1, idx3)
                hi_s = torch.gather(hi_p, 1, idx3)
                costs.append(_half_sa(lo_s[:, :half], hi_s[:, :half])
                             + _half_sa(lo_s[:, half:], hi_s[:, half:]))
                orders.append(order_a)
            best = torch.argmin(torch.stack(costs), dim=0)
            order = torch.where(
                (best == 0)[:, None], orders[0],
                torch.where((best == 1)[:, None], orders[1], orders[2]))
        else:
            finite = c[..., 0] < 1e38
            lo = torch.where(finite[..., None], c, 3e38).amin(dim=1)
            hi = torch.where(finite[..., None], c, -3e38).amax(dim=1)
            axis = torch.argmax(hi - lo, dim=-1)
            key = torch.gather(
                c, 2, axis[:, None, None].expand(n_seg, seg, 1))[..., 0]
            order = torch.argsort(key, dim=1, stable=True)
        perm = torch.gather(perm.reshape(n_seg, seg), 1, order).reshape(-1)
    return perm


def _build_kd_tree(v1, e1, e2, K: int, T: int,
                   sah_axis: bool = True) -> ClusterBVH:
    """Full kd build: the heap layout is the kernel's layout."""
    assert T & (T - 1) == 0, "treelet_size must be a power of two"
    assert K % 8 == 0, "cluster_size must be a multiple of 8"
    dev = v1.device
    F = v1.shape[0]
    Cp = 1 << max(1, int(math.ceil(math.log2(-(-F // K)))))
    S = Cp // T
    if S <= 1:
        # fewer than two treelets: one radix tree (JAX :310-313)
        return _build_single_tree(*_sorted_cluster_data(v1, e1, e2, K), K=K)
    Fp = Cp * K

    lo, hi = triangle_aabbs(v1, e1, e2)
    cent = 0.5 * (lo + hi)
    pad = Fp - F
    if pad:
        def padv(a, val):
            return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), val,
                                            dtype=a.dtype, device=dev)])
        v1, e1, e2 = padv(v1, 0.0), padv(e1, 0.0), padv(e2, 0.0)
        lo, hi = padv(lo, math.inf), padv(hi, -math.inf)
        cent = padv(cent, 3e38)

    perm = _kd_sort(cent, int(math.log2(Cp)),
                    tri_lo=lo if sah_axis else None,
                    tri_hi=hi if sah_axis else None)
    v1s, e1s, e2s = take(v1, perm), take(e1, perm), take(e2, perm)
    prim_ids = torch.where(perm < F, perm, 0)
    los, his = take(lo, perm), take(hi, perm)

    cl_lo = torch.amin(los.reshape(Cp, K, 3), dim=1)
    cl_hi = torch.amax(his.reshape(Cp, K, 3), dim=1)
    cl_lo = torch.where(torch.isfinite(cl_lo), cl_lo, 1e30)
    cl_hi = torch.where(torch.isfinite(cl_hi), cl_hi, -1e30)

    left = 2 * torch.arange(Cp - 1, dtype=torch.int64, device=dev) + 1
    right = left + 1
    node_lo, node_hi = refit(left, right, cl_lo, cl_hi)
    node_lo = torch.where(torch.isfinite(node_lo), node_lo, 1e30)
    node_hi = torch.where(torch.isfinite(node_hi), node_hi, -1e30)

    tri_cols = torch.cat([
        v1s.reshape(Cp, K, 3), e1s.reshape(Cp, K, 3), e2s.reshape(Cp, K, 3),
        prim_ids.reshape(Cp, K, 1).to(torch.float32),
        torch.zeros((Cp, K, 6), dtype=torch.float32, device=dev),
    ], dim=-1)
    half_boxes = K >= 16
    if half_boxes:
        # the two K/2 halves are the cluster's own kd children; their
        # boxes ride the pad columns of records 0 and 1
        h_lo = los.reshape(Cp, 2, K // 2, 3).amin(dim=2)
        h_hi = his.reshape(Cp, 2, K // 2, 3).amax(dim=2)
        h_lo = torch.where(torch.isfinite(h_lo), h_lo, 1e30)
        h_hi = torch.where(torch.isfinite(h_hi), h_hi, -1e30)
        for h in range(2):
            tri_cols[:, h, 10:13] = h_lo[:, h]
            tri_cols[:, h, 13:16] = h_hi[:, h]
    tris = tri_cols.reshape(Cp, K // 8, 128)

    zeros = torch.zeros((Cp,), dtype=torch.float32, device=dev)
    nodes = torch.stack([
        node_lo[:, 0], node_lo[:, 1], node_lo[:, 2],
        node_hi[:, 0], node_hi[:, 1], node_hi[:, 2],
        torch.cat([left.to(torch.float32), zeros]),
        torch.cat([right.to(torch.float32), zeros]),
    ], dim=1).contiguous()

    return ClusterBVH(
        nodes=nodes, tris=tris.contiguous(), num_clusters=int(Cp),
        cluster_size=K, treelet_size=int(T), num_treelets=int(S),
        treelet_lo=node_lo[S - 1: 2 * S - 1].contiguous(),
        treelet_hi=node_hi[S - 1: 2 * S - 1].contiguous(),
        treelet_roots=(S - 1) + torch.arange(S, dtype=torch.int32,
                                             device=dev),
        heap=True, half_boxes=bool(half_boxes),
        depth=int(math.log2(Cp)))
