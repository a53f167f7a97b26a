"""Traversal front-end: closest_hit / any_hit over a Scene (port of the
ClusterBVH, brute-force, sphere and plane branches of ops/trace.py), and
``TraceConfig``, the traversal switches that the JAX package reads from
its environment.

Hit filters, multi_hit and the LBVH tier are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from visionaray_torch.core.types import (
    FLT_MAX, HitRecord, Ray, is_closer, update_if,
)
from visionaray_torch.device import take
from visionaray_torch.ops.cluster_bvh import ClusterBVH
from visionaray_torch.ops.intersect import (
    intersect_plane, intersect_sphere, intersect_triangle,
)

PRIM_TRIANGLE = 0
PRIM_SPHERE = 1
PRIM_PLANE = 2

_CHUNK = 512   # brute-force primitive chunk (bounds the N x F matrix)


@dataclass(frozen=True)
class TraceConfig:
    """The JAX package's process switches of the traversal, as one value.

    Each field is the counterpart of an environment variable of the JAX
    package, with its default:

    - ``fanout`` (VSNRAY_FANOUT, 2): kernel descent width on heap trees,
      2, 4 or 8 (PERF.md row 1f); a radix tree always descends 2 wide.
    - ``half_skip`` (VSNRAY_HALFSKIP, off): the kernel's half-cluster skip,
      on trees that carry half boxes (kd builds with K >= 16).
    - ``dir_bits`` (VSNRAY_DIRBITS, 0): in-octant direction bits in place of
      as many low morton bits of the binned path's sort key, 0..19.
    - ``shadow_m`` (VSNRAY_SHADOW_M, 3): treelet slots of binned any-hit.
    - ``shadow_binned`` (VSNRAY_SHADOW_BINNED, on): NEE shadow rays of
      bounces 1.. through binned any-hit; off, through coherent any-hit.
    - ``shadow_reversed`` (VSNRAY_SHADOW_REVERSED, on): each NEE shadow
      segment traced from the light end; off, from the surface.

    None of them changes what a query answers, only how it is traced.
    """

    fanout: int = 2
    half_skip: bool = False
    dir_bits: int = 0
    shadow_m: int = 3
    shadow_binned: bool = True
    shadow_reversed: bool = True

    def __post_init__(self):
        if self.fanout not in (2, 4, 8):
            raise ValueError(f"TraceConfig: fanout must be 2, 4 or 8, got "
                             f"{self.fanout}")
        if not 0 <= self.dir_bits <= 19:
            raise ValueError(f"TraceConfig: dir_bits must be in [0, 19], "
                             f"got {self.dir_bits}")
        if self.shadow_m < 1:
            raise ValueError(f"TraceConfig: shadow_m must be >= 1, got "
                             f"{self.shadow_m}")


DEFAULT_TRACE = TraceConfig()


def _check_unported(bvh, hit_filter):
    if hit_filter is not None:
        raise NotImplementedError("hit filters are not ported yet "
                                  "(ROADMAP queue 1, item 8)")
    if bvh is not None and not isinstance(bvh, ClusterBVH):
        raise NotImplementedError("only the ClusterBVH tier is ported "
                                  "(the LBVH tier is ROADMAP queue 1, item 9)")


def _best_of(t, hit, max_t=None):
    """Index of the closest valid hit along the last axis (first on ties);
    returns (idx, best_t, best_valid)."""
    valid = hit & (t >= 0.0)
    if max_t is not None:
        valid = valid & (t < max_t[..., None])
    tt = torch.where(valid, t, FLT_MAX)
    idx = torch.argmin(tt, dim=-1)
    best_t = torch.gather(tt, -1, idx[..., None])[..., 0]
    return idx, best_t, best_t < FLT_MAX


def _merge(dst: HitRecord, src: HitRecord, max_t=None) -> HitRecord:
    return update_if(dst, src, is_closer(src, dst.t, max_t))


def intersect_triangles_brute(ray: Ray, v1, e1, e2, geom_ids,
                              prim_offset: int = 0) -> HitRecord:
    """Chunked brute-force sweep over a triangle soup."""
    F = v1.shape[0]
    o = ray.ori[..., None, :]
    d = ray.dir[..., None, :]
    best = HitRecord.none(ray.batch_shape, v1.device)
    for c0 in range(0, max(F, 1), _CHUNK):
        c1 = min(c0 + _CHUNK, F)
        t, u, v, hit = intersect_triangle(o, d, v1[c0:c1], e1[c0:c1],
                                          e2[c0:c1])
        idx, best_t, best_hit = _best_of(t, hit)

        def pick(a):
            return torch.gather(a, -1, idx[..., None])[..., 0]

        src = HitRecord(
            hit=best_hit,
            t=torch.where(best_hit, best_t, FLT_MAX),
            prim_id=(idx + c0 + prim_offset).to(torch.int32),
            geom_id=take(geom_ids[c0:c1], idx),
            u=pick(u), v=pick(v))
        if F <= _CHUNK:
            return src
        best = _merge(best, src)
    return best


def _brute_one_hit(t, hit, geom_ids, prim_offset):
    idx, best_t, best_hit = _best_of(t, hit)
    return HitRecord(
        hit=best_hit,
        t=torch.where(best_hit, best_t, FLT_MAX),
        prim_id=(idx + prim_offset).to(torch.int32),
        geom_id=take(geom_ids, idx),
        u=torch.zeros_like(best_t), v=torch.zeros_like(best_t))


def intersect_spheres_brute(ray: Ray, center, radius, geom_ids,
                            prim_offset: int = 0) -> HitRecord:
    t, hit = intersect_sphere(ray.ori[..., None, :], ray.dir[..., None, :],
                              center, radius)
    return _brute_one_hit(t, hit, geom_ids, prim_offset)


def intersect_planes_brute(ray: Ray, normal, offset, geom_ids,
                           prim_offset: int = 0) -> HitRecord:
    t, hit = intersect_plane(ray.ori[..., None, :], ray.dir[..., None, :],
                             normal, offset)
    return _brute_one_hit(t, hit, geom_ids, prim_offset)


def _other_groups(ray, scene, best, merge):
    offset = scene.num_triangles
    if scene.spheres is not None:
        best = merge(best, intersect_spheres_brute(
            ray, scene.spheres.center, scene.spheres.radius,
            scene.spheres.geom_ids, offset))
        offset += scene.num_spheres
    if scene.planes is not None:
        best = merge(best, intersect_planes_brute(
            ray, scene.planes.normal, scene.planes.offset,
            scene.planes.geom_ids, offset))
    return best


def closest_hit(ray: Ray, scene, use_bvh: Optional[bool] = None,
                hit_filter=None, binned: bool = False, max_t=None,
                trace: TraceConfig = DEFAULT_TRACE) -> HitRecord:
    """Closest-hit query over the whole scene.

    Triangles go through the ClusterBVH when ``scene.bvh`` is set
    (``binned``: the treelet-binned path for incoherent rays), else a
    brute-force sweep; spheres and planes are swept.  ``max_t``: per-lane
    bound; lanes with max_t <= 0 are dead and never traverse.  ``trace``:
    the traversal switches (fanout, half_skip, dir_bits).
    """
    _check_unported(scene.bvh, hit_filter)
    from visionaray_torch.ops.traverse import (
        binned_closest_hit, cluster_closest_hit,
    )
    best = HitRecord.none(ray.batch_shape, ray.dir.device)
    if scene.mesh is not None:
        if use_bvh is None:
            use_bvh = scene.bvh is not None
        mt = FLT_MAX if max_t is None else max_t
        kw = dict(fanout=trace.fanout, half_skip=trace.half_skip)
        if use_bvh and binned and scene.bvh.treelet_size > 0:
            hr = binned_closest_hit(ray, scene.bvh, scene.mesh, max_t=mt,
                                    dir_bits=trace.dir_bits, **kw)
        elif use_bvh:
            hr = cluster_closest_hit(ray, scene.bvh, scene.mesh, max_t=mt,
                                     **kw)
        else:
            v1, e1, e2 = scene.mesh.corners()
            hr = intersect_triangles_brute(ray, v1, e1, e2,
                                           scene.mesh.geom_ids)
        best = _merge(best, hr)
    best = _other_groups(ray, scene, best, _merge)
    if max_t is not None:
        keep = best.hit & (best.t < max_t)
        best = HitRecord(
            hit=keep, t=torch.where(keep, best.t, FLT_MAX),
            prim_id=best.prim_id, geom_id=best.geom_id,
            u=torch.where(keep, best.u, 0.0),
            v=torch.where(keep, best.v, 0.0))
    return best


def any_hit(ray: Ray, scene, max_t, use_bvh: Optional[bool] = None,
            hit_filter=None, binned: bool = False,
            trace: TraceConfig = DEFAULT_TRACE) -> HitRecord:
    """Any-hit (occlusion) query: a hit counts iff hit && 0 <= t < max_t.
    ``binned`` takes ``trace.shadow_m`` treelet slots."""
    _check_unported(scene.bvh, hit_filter)
    from visionaray_torch.ops.traverse import binned_any_hit, cluster_any_hit
    best = HitRecord.none(ray.batch_shape, ray.dir.device)

    def merge(dst, src):
        return update_if(dst, src, is_closer(src, dst.t, max_t))

    if scene.mesh is not None:
        if use_bvh is None:
            use_bvh = scene.bvh is not None
        kw = dict(fanout=trace.fanout, half_skip=trace.half_skip)
        if use_bvh and binned and scene.bvh.treelet_size > 0:
            hr = binned_any_hit(ray, scene.bvh, scene.mesh, max_t,
                                m=trace.shadow_m, dir_bits=trace.dir_bits,
                                **kw)
        elif use_bvh:
            hr = cluster_any_hit(ray, scene.bvh, scene.mesh, max_t, **kw)
        else:
            v1, e1, e2 = scene.mesh.corners()
            hr = intersect_triangles_brute(ray, v1, e1, e2,
                                           scene.mesh.geom_ids)
        best = merge(best, hr)
    return _other_groups(ray, scene, best, merge)


def prim_type_of(scene, prim_id):
    """Map global prim ids to group tags (triangle/sphere/plane)."""
    nt = scene.num_triangles
    ns = scene.num_spheres
    return torch.where(prim_id < nt, PRIM_TRIANGLE,
                       torch.where(prim_id < nt + ns, PRIM_SPHERE,
                                   PRIM_PLANE)).to(torch.int32)
