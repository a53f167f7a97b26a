"""BVH introspection: AABB-outline rendering + structure statistics (port
of utils/bvh_debug.py, a numpy copy over the port's trees: the tables are
copied to the host).

The reference draws node AABBs as GL line lists over the frame
(gl/bvh_outline_renderer.h:25-140) and surfaces node counts in the viewer
HUD (src/viewer/viewer.cpp:383-397).  Headless analogue: an orthographic
PNG dump of node outlines, level-colored, plus a stats dict.
"""

from __future__ import annotations

import numpy as np

from visionaray_torch.device import to_numpy



def _extract(bvh):
    """(node_lo, node_hi, left, right, leaf_base) from either BVH type."""
    if hasattr(bvh, "nodes"):         # ops.cluster_bvh.ClusterBVH
        nodes = to_numpy(bvh.nodes)
        lo, hi = nodes[:, 0:3], nodes[:, 3:6]
        left = nodes[:, 6].astype(np.int64)
        right = nodes[:, 7].astype(np.int64)
        leaf_base = bvh.num_clusters - 1
        return lo, hi, left, right, leaf_base
    lo = to_numpy(bvh.node_lo)           # ops.lbvh.BVH
    hi = to_numpy(bvh.node_hi)
    return (lo, hi, to_numpy(bvh.left).astype(np.int64),
            to_numpy(bvh.right).astype(np.int64), bvh.num_leaves - 1)


def node_depths(bvh):
    """(depths, max_depth): per-node depth by BFS from the root."""
    lo, _, left, right, leaf_base = _extract(bvh)
    n = lo.shape[0]
    depth = np.full(n, -1, np.int64)
    depth[0] = 0
    frontier = [0]
    while frontier:
        nxt = []
        for u in frontier:
            if u < leaf_base:
                for c in (int(left[u]), int(right[u])):
                    if 0 <= c < n and depth[c] < 0:
                        depth[c] = depth[u] + 1
                        nxt.append(c)
        frontier = nxt
    return depth, int(depth.max(initial=0))


def _level_color(t):
    """Depth 0..1 -> RGB ramp (blue roots -> green -> red deep levels)."""
    r = np.clip(2.0 * t - 0.6, 0.0, 1.0)
    g = 1.0 - np.abs(2.0 * t - 1.0) * 0.8
    b = np.clip(1.2 - 2.0 * t, 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def bvh_outline_image(bvh, width: int = 1024, axes=(0, 1),
                      max_depth: int | None = None):
    """Orthographic AABB-outline rendering, level-colored; (H, W, 4) f32.

    ``axes``: the two world axes projected to image (x, y).  Deeper levels
    draw later (on top) so leaf structure stays visible.
    """
    lo, hi, _, _, _ = _extract(bvh)
    depth, dmax = node_depths(bvh)
    keep = depth >= 0
    if max_depth is not None:
        keep &= depth <= max_depth
        dmax = min(dmax, max_depth)
    ax, ay = axes
    wlo = lo[0] if lo.shape[0] > 1 else lo[-1]
    whi = hi[0] if hi.shape[0] > 1 else hi[-1]
    ext = np.maximum(whi - wlo, 1e-9)
    height = max(int(round(width * ext[ay] / ext[ax])), 8)
    img = np.zeros((height, width, 4), np.float32)
    img[..., 3] = 1.0

    def px(v, axis, n):
        return np.clip(((v - wlo[axis]) / ext[axis] * (n - 1)).astype(int),
                       0, n - 1)

    order = np.argsort(depth[keep])
    idx = np.nonzero(keep)[0][order]
    colors = _level_color(depth / max(dmax, 1))
    for i in idx:
        if (hi[i] < lo[i]).any():     # empty padding node
            continue
        x0, x1 = px(lo[i, ax], ax, width), px(hi[i, ax], ax, width)
        y0, y1 = px(lo[i, ay], ay, height), px(hi[i, ay], ay, height)
        c = colors[i]
        a = 0.25 + 0.75 * depth[i] / max(dmax, 1)
        for (ys, xs) in ((slice(y0, y1 + 1), slice(x0, x0 + 1)),
                         (slice(y0, y1 + 1), slice(x1, x1 + 1)),
                         (slice(y0, y0 + 1), slice(x0, x1 + 1)),
                         (slice(y1, y1 + 1), slice(x0, x1 + 1))):
            img[ys, xs, :3] = (1 - a) * img[ys, xs, :3] + a * c
    return img


def bvh_stats(bvh) -> dict:
    """nodes/leaves/depth/SAH cost (+ treelet overlap factor when built)."""
    lo, hi, _, _, leaf_base = _extract(bvh)
    _, dmax = node_depths(bvh)
    ext = np.maximum(hi - lo, 0.0)
    area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                  + ext[:, 2] * ext[:, 0])
    root = max(float(area[0] if lo.shape[0] > 1 else area[-1]), 1e-30)
    empty = (hi[:, 0] < lo[:, 0])
    area = np.where(empty, 0.0, area)
    stats = {
        "nodes": int(lo.shape[0]),
        "internal": int(leaf_base),
        "leaves": int(lo.shape[0] - leaf_base),
        "max_depth": dmax,
        # Karras-Aila constants, as ops/lbvh.sah_cost (statistics.h:38)
        "sah_cost": float((1.0 * area[:leaf_base].sum()
                           + 1.2 * area[leaf_base:].sum()) / root),
    }
    if getattr(bvh, "treelet_lo", None) is not None:
        tlo = to_numpy(bvh.treelet_lo)
        thi = to_numpy(bvh.treelet_hi)
        text = np.maximum(thi - tlo, 0.0)
        ta = 2.0 * (text[:, 0] * text[:, 1] + text[:, 1] * text[:, 2]
                    + text[:, 2] * text[:, 0])
        # expected number of treelet boxes covering a random point of the
        # root box (the overlap factor), volume-based
        vol = np.prod(np.maximum(hi[0] - lo[0], 1e-30))
        tvol = np.prod(text, axis=1)
        stats["num_treelets"] = int(tlo.shape[0])
        stats["treelet_overlap_factor"] = float(tvol.sum() / vol)
        stats["treelet_area_ratio"] = float(ta.sum() / root)
    return stats


def dump_bvh(bvh, path: str, width: int = 1024, axes=(0, 1),
             max_depth=None) -> dict:
    """Write the outline PNG (a PPM without Pillow: ``io.image.save_png``)
    and return the stats dict, with the path written under ``"path"``."""
    from visionaray_torch.io.image import save_png
    img = bvh_outline_image(bvh, width=width, axes=axes,
                            max_depth=max_depth)
    written = save_png(path, img, srgb=False)
    return {**bvh_stats(bvh), "path": str(written)}
