"""Traversal front-end: closest_hit / any_hit / multi_hit over a Scene
(port of the ClusterBVH, brute-force, sphere and plane branches of
ops/trace.py), and ``TraceConfig``, the traversal switches that the JAX
package reads from its environment.

``hit_filter`` is the custom-intersector hook, ``fn(prim_id, t, u, v, hit)
-> hit``, applied to every candidate triangle hit: on the brute-force tier
inside the sweep, on the ClusterBVH tier by re-tracing past each rejected
winner (the kernel has no per-leaf hook).  The LBVH tier is not ported
yet.
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


def _check_unported(bvh):
    if bvh is not None and not isinstance(bvh, ClusterBVH):
        raise NotImplementedError("only the ClusterBVH tier is ported "
                                  "(the LBVH tier is ROADMAP queue 1, item 5)")


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
                              prim_offset: int = 0,
                              hit_filter=None) -> HitRecord:
    """Chunked brute-force sweep over a triangle soup; ``hit_filter``
    drops candidates before the closest-merge."""
    F = v1.shape[0]
    o = ray.ori[..., None, :]
    d = ray.dir[..., None, :]
    best = HitRecord.none(ray.batch_shape, v1.device)
    for c0 in range(0, max(F, 1), _CHUNK):
        c1 = min(c0 + _CHUNK, F)
        t, u, v, hit = intersect_triangle(o, d, v1[c0:c1], e1[c0:c1],
                                          e2[c0:c1])
        if hit_filter is not None:
            pid = torch.arange(c0 + prim_offset, c1 + prim_offset,
                               dtype=torch.int32, device=t.device)
            hit = hit_filter(pid.expand(t.shape), t, u, v, hit)
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


_FILTER_RETRACE_CAP = 16   # re-traces of a filtered query (multi_hit's N)


def _filtered_search(ray: Ray, cbvh, mesh, hit_filter, max_t,
                     trace: TraceConfig) -> HitRecord:
    """The detached search of ``_cluster_closest_filtered``: trace, ask
    the filter about each lane's winner, and re-trace the lanes whose
    winner it rejected from just past that hit, with that primitive
    excluded (so coplanar or zero-distance repeats cannot livelock), up to
    _FILTER_RETRACE_CAP launches.  Resolved lanes carry max_t = -1 and
    never enter a tile.  One host sync per launch (``any(unresolved)``)."""
    from visionaray_torch.ops.traverse import cluster_closest_hit

    batch = ray.batch_shape
    dev = ray.dir.device
    so, sd = ray.ori.detach(), ray.dir.detach()
    mtb = torch.as_tensor(max_t, dtype=torch.float32,
                          device=dev).detach().expand(batch)
    best = HitRecord.none(batch, dev)
    t0 = torch.zeros(batch, dtype=torch.float32, device=dev)
    excl = torch.full(batch, -1, dtype=torch.int32, device=dev)
    unresolved = mtb > 0.0
    for _ in range(_FILTER_RETRACE_CAP):
        if not bool(unresolved.any()):
            break
        hr = cluster_closest_hit(
            Ray(ori=so + sd * t0[..., None], dir=sd), cbvh, mesh,
            max_t=torch.where(unresolved, mtb - t0, -1.0),
            fanout=trace.fanout, half_skip=trace.half_skip)
        # a re-hit of the excluded prim: step past it and go on
        same = hr.hit & (hr.prim_id == excl)
        hit = hr.hit & ~same
        t = torch.where(same, FLT_MAX, hr.t)
        keep = hit_filter(hr.prim_id, t + t0, hr.u, hr.v, hit)
        accept = unresolved & hit & keep
        rejected = unresolved & ((hit & ~keep) | same)
        # where the nudge did not clear the surface numerically, advance by
        # a t0-proportional epsilon (the cap bounds the loop, not this)
        adv_t = torch.where(same, torch.clamp_min(t0 * 1e-5, 1e-6), t)
        best = HitRecord(
            hit=best.hit | accept,
            t=torch.where(accept, t + t0, best.t),
            prim_id=torch.where(accept, hr.prim_id, best.prim_id),
            geom_id=torch.where(accept, hr.geom_id, best.geom_id),
            u=torch.where(accept, hr.u, best.u),
            v=torch.where(accept, hr.v, best.v))
        t0 = torch.where(rejected, t0 + adv_t * (1.0 + 1e-5) + 1e-7, t0)
        excl = torch.where(rejected, hr.prim_id, -1)
        unresolved = rejected
    return best


def _recompute_hits(ray_ori, ray_dir, mesh, hit, pid):
    """(t, u, v, pid, geom_id) at fixed prims ``pid`` (0 where not
    ``hit``), differentiable in the ray and the vertices."""
    pid = torch.where(hit, pid, 0).to(torch.int32)
    v1, e1, e2 = mesh.corners()
    t, u, v, _ = intersect_triangle(ray_ori, ray_dir, take(v1, pid),
                                    take(e1, pid), take(e2, pid))
    return (torch.where(hit, t, FLT_MAX), torch.where(hit, u, 0.0),
            torch.where(hit, v, 0.0), pid, take(mesh.geom_ids, pid))


def _cluster_closest_filtered(ray: Ray, cbvh, mesh, hit_filter,
                              max_t=FLT_MAX,
                              trace: TraceConfig = DEFAULT_TRACE
                              ) -> HitRecord:
    """Closest *surviving* hit on the ClusterBVH tier: the detached
    search of ``_filtered_search``, then t, u, v recomputed at the winning
    primitive from the original ray, differentiably."""
    with torch.no_grad():
        best = _filtered_search(ray, cbvh, mesh, hit_filter, max_t, trace)
    t, u, v, pid, gid = _recompute_hits(ray.ori, ray.dir, mesh, best.hit,
                                        best.prim_id)
    return HitRecord(hit=best.hit, t=t, prim_id=pid, geom_id=gid, u=u, v=v)


def closest_hit(ray: Ray, scene, use_bvh: Optional[bool] = None,
                hit_filter=None, binned: bool = False, max_t=None,
                trace: TraceConfig = DEFAULT_TRACE) -> HitRecord:
    """Closest-hit query over the whole scene.

    Triangles go through the ClusterBVH when ``scene.bvh`` is set
    (``binned``: the treelet-binned path for incoherent rays), else a
    brute-force sweep; spheres and planes are swept.  ``hit_filter``: a
    rejected winner falls through to the next hit (on the ClusterBVH by
    re-tracing, coherent tiles).  ``max_t``: per-lane bound; lanes with
    max_t <= 0 are dead and never traverse.  ``trace``: the traversal
    switches (fanout, half_skip, dir_bits).
    """
    _check_unported(scene.bvh)
    from visionaray_torch.ops.traverse import (
        binned_closest_hit, cluster_closest_hit,
    )
    best = HitRecord.none(ray.batch_shape, ray.dir.device)
    if scene.mesh is not None:
        if use_bvh is None:
            use_bvh = scene.bvh is not None
        mt = FLT_MAX if max_t is None else max_t
        kw = dict(fanout=trace.fanout, half_skip=trace.half_skip)
        if use_bvh and hit_filter is not None:
            hr = _cluster_closest_filtered(ray, scene.bvh, scene.mesh,
                                           hit_filter, max_t=mt, trace=trace)
        elif use_bvh and binned and scene.bvh.treelet_size > 0:
            hr = binned_closest_hit(ray, scene.bvh, scene.mesh, max_t=mt,
                                    dir_bits=trace.dir_bits, **kw)
        elif use_bvh:
            hr = cluster_closest_hit(ray, scene.bvh, scene.mesh, max_t=mt,
                                     **kw)
        else:
            v1, e1, e2 = scene.mesh.corners()
            hr = intersect_triangles_brute(ray, v1, e1, e2,
                                           scene.mesh.geom_ids,
                                           hit_filter=hit_filter)
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
    ``binned`` takes ``trace.shadow_m`` treelet slots.  Through a
    ``hit_filter`` the ClusterBVH tier answers with the closest surviving
    hit, so occlusion sees through rejected (e.g. alpha-masked) hits."""
    _check_unported(scene.bvh)
    from visionaray_torch.ops.traverse import binned_any_hit, cluster_any_hit
    best = HitRecord.none(ray.batch_shape, ray.dir.device)

    def merge(dst, src):
        return update_if(dst, src, is_closer(src, dst.t, max_t))

    if scene.mesh is not None:
        if use_bvh is None:
            use_bvh = scene.bvh is not None
        kw = dict(fanout=trace.fanout, half_skip=trace.half_skip)
        if use_bvh and hit_filter is not None:
            hr = _cluster_closest_filtered(ray, scene.bvh, scene.mesh,
                                           hit_filter, max_t=max_t,
                                           trace=trace)
        elif use_bvh and binned and scene.bvh.treelet_size > 0:
            hr = binned_any_hit(ray, scene.bvh, scene.mesh, max_t,
                                m=trace.shadow_m, dir_bits=trace.dir_bits,
                                **kw)
        elif use_bvh:
            hr = cluster_any_hit(ray, scene.bvh, scene.mesh, max_t, **kw)
        else:
            v1, e1, e2 = scene.mesh.corners()
            hr = intersect_triangles_brute(ray, v1, e1, e2,
                                           scene.mesh.geom_ids,
                                           hit_filter=hit_filter)
        best = merge(best, hr)
    return _other_groups(ray, scene, best, merge)


def _cluster_multi_hit(ray: Ray, cbvh, mesh, k: int):
    """Top-k triangle hits on the ClusterBVH tier: k closest-hit launches,
    each from just past the previous winner with that primitive excluded;
    lanes out of hits carry max_t = -1.  Surfaces coincident within the
    advance epsilon beyond the first are skipped.  Returns (t, hit,
    prim_id, geom_id, u, v), each (..., k), sorted by t by construction,
    differentiable by recompute."""
    from visionaray_torch.ops.traverse import cluster_closest_hit

    batch = ray.batch_shape
    dev = ray.dir.device
    with torch.no_grad():
        so, sd = ray.ori.detach(), ray.dir.detach()
        t0 = torch.zeros(batch, dtype=torch.float32, device=dev)
        excl = torch.full(batch, -1, dtype=torch.int32, device=dev)
        live = torch.ones(batch, dtype=torch.bool, device=dev)
        oks, pids = [], []
        for _ in range(k):
            hr = cluster_closest_hit(
                Ray(ori=so + sd * t0[..., None], dir=sd), cbvh, mesh,
                max_t=torch.where(live, FLT_MAX, -1.0))
            ok = live & hr.hit & (hr.prim_id != excl)
            oks.append(ok)
            pids.append(hr.prim_id)
            t0 = torch.where(ok, t0 + hr.t * (1.0 + 1e-6) + 1e-7, t0)
            excl = torch.where(ok, hr.prim_id, -1)
            live = ok
        hit_k = torch.stack(oks, dim=-1)
        pid_k = torch.stack(pids, dim=-1)
    t, u, v, pid, gid = _recompute_hits(ray.ori[..., None, :],
                                        ray.dir[..., None, :], mesh, hit_k,
                                        pid_k)
    return t, hit_k, pid, gid, u, v


def _swept_group(t, hit, n, offset, geom_ids, u=None, v=None):
    pid = torch.arange(offset, offset + n, dtype=torch.int32,
                       device=t.device).expand(t.shape)
    z = torch.zeros_like(t)
    return (t, hit, pid, geom_ids.expand(t.shape),
            z if u is None else u, z if v is None else v)


def multi_hit(ray: Ray, scene, k: int = 16,
              use_bvh: Optional[bool] = None) -> HitRecord:
    """The k nearest hits per ray, sorted by t: a HitRecord whose fields
    carry a trailing k axis, unused slots hit=False, t=FLT_MAX.  Triangles
    take k re-traces on the ClusterBVH (when built) or a sweep; spheres and
    planes are swept; all merged by a stable sort on t (ties: lower prim
    first, as ``lax.top_k``)."""
    _check_unported(scene.bvh)
    groups = []   # (t, hit, prim_id, geom_id, u, v) each (..., M_g)
    o = ray.ori[..., None, :]
    d = ray.dir[..., None, :]
    offset = 0
    if scene.mesh is not None:
        if use_bvh is None:
            use_bvh = scene.bvh is not None
        if use_bvh:
            groups.append(_cluster_multi_hit(ray, scene.bvh, scene.mesh, k))
        else:
            v1, e1, e2 = scene.mesh.corners()
            t, u, v, hit = intersect_triangle(o, d, v1, e1, e2)
            groups.append(_swept_group(t, hit, scene.num_triangles, offset,
                                       scene.mesh.geom_ids, u, v))
        offset += scene.num_triangles
    if scene.spheres is not None:
        t, hit = intersect_sphere(o, d, scene.spheres.center,
                                  scene.spheres.radius)
        groups.append(_swept_group(t, hit, scene.num_spheres, offset,
                                   scene.spheres.geom_ids))
        offset += scene.num_spheres
    if scene.planes is not None:
        t, hit = intersect_plane(o, d, scene.planes.normal,
                                 scene.planes.offset)
        groups.append(_swept_group(t, hit, scene.num_planes, offset,
                                   scene.planes.geom_ids))

    t, hit, pid, gid, u, v = (torch.cat(f, dim=-1) for f in zip(*groups))
    tt = torch.where(hit & (t >= 0.0), t, FLT_MAX)
    kk = min(k, tt.shape[-1])
    idx = torch.sort(tt, dim=-1, stable=True).indices[..., :kk]

    def pick(a, fill):
        a = torch.gather(a, -1, idx)
        if kk == k:
            return a
        pad = torch.full(a.shape[:-1] + (k - kk,), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a, pad], dim=-1)

    tk = pick(tt, FLT_MAX)
    return HitRecord(hit=tk < FLT_MAX, t=tk, prim_id=pick(pid, 0),
                     geom_id=pick(gid, 0), u=pick(u, 0.0), v=pick(v, 0.0))


def prim_type_of(scene, prim_id):
    """Map global prim ids to group tags (triangle/sphere/plane)."""
    nt = scene.num_triangles
    ns = scene.num_spheres
    return torch.where(prim_id < nt, PRIM_TRIANGLE,
                       torch.where(prim_id < nt + ns, PRIM_SPHERE,
                                   PRIM_PLANE)).to(torch.int32)
