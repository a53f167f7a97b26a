"""Geometry-sharded tracing: a ring of ray batches over the ranks (port of
parallel/ring.py).

For scenes too large to replicate on each card (BASELINE config #5:
instanced Sponza x16 at 4K), the mesh is split spatially into D shards;
each rank owns one sub-mesh (a triangle soup) and its own tree, and the
rays visit every shard around a ring of ``hop``s (parallel/comm.py,
``ppermute`` in JAX), carrying a running closest hit:

Round r (of D):
  1. shard-box cull: lanes whose live segment [0, best_t) misses this
     shard's box carry max_t = -1 and take no part in the local trace;
  2. the others trace the local tree (built once, outside the ring) with
     max_t = best_t;
  3. the winner's (t, u, v) are recomputed differentiably at its local
     triangle in the same hop (each backend's closest hit recomputes at
     the winning primitive), so no second gradient rotation is needed;
  4. rays and the carried best go to the next rank.
After D rounds every ray is home with the closest hit of all shards.

The hop is an autograd Function whose backward runs the step the other
way, so ``backward()`` is collective: every rank runs all D hops of every
query (lanes or no lanes) and every rank calls it.

Memory: a shard holds ceil(F/D) triangles (soup form, 36 B each, more
with shading data) and its tree; ``shard_geometry(..., shards=(rank,))``
keeps only the rank's own, about 1/D of the scene on each card.  Morton
order keeps the shards' boxes compact, so the cull skips most (ray,
shard) pairs.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.core.types import FLT_MAX, HitRecord, Ray
from visionaray_torch.core.vecmath import cross, safe_normalize
from visionaray_torch.device import take
from visionaray_torch.ops.intersect import intersect_aabb
from visionaray_torch.ops.lbvh import (
    build_lbvh_from_aabbs, morton3d, triangle_aabbs,
)
from visionaray_torch.parallel.comm import Mesh, all_gather, hop

SHARD_AXIS = "shards"

BACKENDS = ("brute", "lbvh", "cluster")

# ints ride a hop's payload as f32 values: exact below 2^24
_EXACT = 1 << 24


@dataclass
class SoupMesh:
    """One or more shards' triangle soups, satisfying the corners() and
    geom_ids contract of the traversal tiers.  ``corner_normals`` (per,
    3, 3) and ``tex_coords`` (per, 3, 2) carry the shading data that the
    ring gathers from the shard owning a hit."""

    v1: Any       # (per, 3), or (S, per, 3) in a ShardedGeometry
    e1: Any
    e2: Any
    geom_ids: Any  # (per,)
    corner_normals: Any = None
    tex_coords: Any = None

    def corners(self):
        return self.v1, self.e1, self.e2

    @property
    def num_prims(self):
        return self.v1.shape[0]


@dataclass
class Shard:
    """One shard as a rank traces it: its soup (per, ...), its tree (None
    for brute force) and its box."""

    soup: SoupMesh
    bvh: Any
    shard_lo: Any   # (3,)
    shard_hi: Any   # (3,)


@dataclass
class ShardedGeometry:
    """A scene split into ``num_shards`` spatially compact shards.

    The arrays carry a leading axis over the shards held here,
    ``shard_ids`` (all of them unless ``shard_geometry`` was asked for
    fewer): ``soup`` fields (S, per, ...), ``prim_ids`` (S, per) the
    original face of each soup slot, ``shard_lo``/``shard_hi`` (S, 3),
    ``bvh`` a list of S per-shard trees (None for brute force).  The soup
    corners are the differentiable leaves; ``soup_grads_to_faces`` maps
    their gradients back to the faces."""

    soup: SoupMesh
    prim_ids: Any
    shard_lo: Any
    shard_hi: Any
    bvh: Any
    backend: str = "lbvh"
    prims_per_shard: int = 0
    num_shards: int = 0
    shard_ids: tuple = ()

    def local(self, shard: int) -> Shard:
        """Shard number ``shard`` (it must be held here)."""
        if shard not in self.shard_ids:
            raise ValueError(f"shard {shard} is not held here (held: "
                             f"{self.shard_ids})")
        i = self.shard_ids.index(shard)
        s = self.soup
        soup = SoupMesh(*[None if f is None else f[i] for f in (
            s.v1, s.e1, s.e2, s.geom_ids, s.corner_normals, s.tex_coords)])
        return Shard(soup=soup, bvh=None if self.bvh is None else self.bvh[i],
                     shard_lo=self.shard_lo[i], shard_hi=self.shard_hi[i])


def shard_geometry(mesh, n_shards: int, backend: str = "lbvh",
                   cluster_size: int = 8, treelet_size: int = 0,
                   with_shading: bool = False,
                   shards=None) -> ShardedGeometry:
    """Partition a TriangleMesh into ``n_shards`` spatially compact shards.

    Faces are sorted by the morton code of their box centres (a stable
    sort, as jnp.argsort is) and cut into D contiguous runs; the tail
    shard is padded by repeating its last face (a duplicate hit ties
    under the ring's strict t < best_t, so it is harmless).  ``shards``:
    the shard indices to keep and build trees for (all when None), so a
    rank keeps only its own shard on its card.  ``with_shading``: also carry
    the per-corner normals and UVs the ring's surface gather reads.
    ``cluster`` builds a radix ClusterBVH per shard (``treelet_size`` 0,
    JAX's default), ``lbvh`` an LBVH, ``brute`` none."""
    if backend not in BACKENDS:
        raise ValueError(f"shard_geometry: backend {backend!r} is not one "
                         f"of {BACKENDS}")
    v1, e1, e2 = mesh.corners()
    F = v1.shape[0]
    with torch.no_grad():
        lo, hi = triangle_aabbs(v1.detach(), e1.detach(), e2.detach())
        centroid = 0.5 * (lo + hi)
        scene_lo = torch.amin(lo, dim=0)
        extent = torch.clamp_min(torch.amax(hi, dim=0) - scene_lo, 1e-9)
        order = torch.argsort(morton3d((centroid - scene_lo) / extent),
                              stable=True).to(torch.int32)
    per = -(-F // n_shards)
    if per >= _EXACT:
        raise ValueError(f"shard_geometry: {per} triangles a shard; the "
                         f"ring carries prim ids as f32 (< 2^24)")
    padn = per * n_shards - F
    if padn:
        order = torch.cat([order, order[-1:].expand(padn)])
    order = order.reshape(n_shards, per)
    keep = tuple(range(n_shards)) if shards is None else tuple(shards)
    order = order[list(keep)]
    S = len(keep)

    def gather(a):
        return take(a, order.reshape(-1)).reshape(
            (S, per) + tuple(a.shape[1:]))

    soup = SoupMesh(
        v1=gather(v1), e1=gather(e1), e2=gather(e2),
        geom_ids=gather(mesh.geom_ids),
        corner_normals=gather(mesh.corner_normals) if with_shading else None,
        tex_coords=gather(mesh.tex_coords) if with_shading else None)
    s_lo, s_hi = gather(lo), gather(hi)
    bvh = None
    with torch.no_grad():
        if backend == "lbvh":
            bvh = [build_lbvh_from_aabbs(s_lo[i], s_hi[i]) for i in range(S)]
        elif backend == "cluster":
            from visionaray_torch.ops.cluster_bvh import (
                build_cluster_bvh_from_corners,
            )
            bvh = [build_cluster_bvh_from_corners(
                soup.v1[i], soup.e1[i], soup.e2[i],
                cluster_size=cluster_size, treelet_size=treelet_size)
                for i in range(S)]
    return ShardedGeometry(
        soup=soup, prim_ids=order,
        shard_lo=torch.amin(s_lo, dim=1), shard_hi=torch.amax(s_hi, dim=1),
        bvh=bvh, backend=backend, prims_per_shard=int(per),
        num_shards=int(n_shards), shard_ids=keep)


def _masked(hr: HitRecord, max_t) -> HitRecord:
    ok = hr.hit & (hr.t < max_t)
    return dataclasses.replace(hr, hit=ok, t=torch.where(ok, hr.t, FLT_MAX))


def _local_closest(ray: Ray, soup: SoupMesh, bvh, backend: str,
                   max_t) -> HitRecord:
    """One shard's closest hit, differentiable by each backend's own
    recompute; prim_id is local to the shard."""
    if backend == "cluster":
        from visionaray_torch.ops.traverse import cluster_closest_hit
        return cluster_closest_hit(ray, bvh, soup, max_t=max_t)
    if backend == "lbvh":
        from visionaray_torch.ops.traversal import bvh_closest_hit
        return bvh_closest_hit(ray, bvh, soup, max_t=max_t)
    from visionaray_torch.ops.trace import intersect_triangles_brute
    return _masked(intersect_triangles_brute(ray, soup.v1, soup.e1, soup.e2,
                                             soup.geom_ids), max_t)


def _local_any(ray: Ray, soup: SoupMesh, bvh, backend: str,
               max_t) -> HitRecord:
    if backend == "cluster":
        from visionaray_torch.ops.traverse import cluster_any_hit
        return cluster_any_hit(ray, bvh, soup, max_t=max_t)
    if backend == "lbvh":
        from visionaray_torch.ops.traversal import bvh_any_hit
        return bvh_any_hit(ray, bvh, soup, max_t=max_t)
    from visionaray_torch.ops.trace import intersect_triangles_brute
    return _masked(intersect_triangles_brute(ray, soup.v1, soup.e1, soup.e2,
                                             soup.geom_ids), max_t)


def _cull(ray: Ray, shard_lo, shard_hi):
    """(tn, tf, hit) of the rays (detached) against the shard's box."""
    d = ray.dir.detach()
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    return intersect_aabb(ray.ori.detach(), inv_d, shard_lo, shard_hi)


def _ring_step(cols, mesh: Mesh):
    """One hop of a payload given as a list of (n, k) f32 columns (ints
    as f32 values); returns the received columns, split alike."""
    widths = [c.shape[1] for c in cols]
    got = hop(torch.cat(cols, dim=1), mesh)
    return list(torch.split(got, widths, dim=1))


def _f(x, n):
    return x.reshape(n, -1).to(torch.float32)


def ring_closest_hit_local(ray: Ray, soup: SoupMesh, bvh, shard_lo,
                           shard_hi, backend: str, mesh: Mesh) -> HitRecord:
    """One rank's rays (``ray``, its block) and shard: each ray's closest
    hit over every shard with differentiable (t, u, v); prim_id is global
    (owner shard * prims per shard + local)."""
    D = mesh.size
    per = soup.num_prims
    batch = ray.batch_shape
    n = math.prod(batch)
    dev = ray.dir.device
    best = HitRecord.none(batch, dev)
    owner = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(D):
        tn, tf, bh = _cull(ray, shard_lo, shard_hi)
        want = bh & (tf >= 0.0) & (tn < best.t)
        mt = torch.where(want, best.t.detach(), -1.0)
        hr = _local_closest(ray, soup, bvh, backend, mt)
        closer = hr.hit & (hr.t < best.t)

        def sel(a, b):
            return torch.where(closer, a, b)

        best = HitRecord(hit=best.hit | closer, t=sel(hr.t, best.t),
                         prim_id=sel(hr.prim_id, best.prim_id),
                         geom_id=sel(hr.geom_id, best.geom_id),
                         u=sel(hr.u, best.u), v=sel(hr.v, best.v))
        owner = torch.where(closer, mesh.rank, owner)
        if D == 1:
            continue
        o, d, t, u, v, ints = _ring_step(
            [_f(ray.ori, n), _f(ray.dir, n), _f(best.t, n), _f(best.u, n),
             _f(best.v, n),
             torch.stack([best.hit.float(), best.prim_id.float(),
                          best.geom_id.float(), owner.float()],
                         dim=-1).reshape(n, 4)], mesh)
        ints = ints.detach().round().to(torch.int32)
        ray = Ray(ori=o.reshape(batch + (3,)), dir=d.reshape(batch + (3,)))
        best = HitRecord(hit=ints[:, 0].reshape(batch) > 0,
                         t=t.reshape(batch),
                         prim_id=ints[:, 1].reshape(batch),
                         geom_id=ints[:, 2].reshape(batch),
                         u=u.reshape(batch), v=v.reshape(batch))
        owner = ints[:, 3].reshape(batch)
    # D rotations: every ray (and its hit) is home again
    return dataclasses.replace(best, prim_id=torch.where(
        best.hit, owner * per + best.prim_id, 0))


def ring_closest_surface_local(ray: Ray, soup: SoupMesh, bvh, shard_lo,
                               shard_hi, backend: str, mesh: Mesh,
                               max_t=FLT_MAX):
    """The closest hit and its surface data over the ring: the sharded
    closest_hit + get_surface.  The hop owning a hit gathers from its
    local soup the per-corner normals interpolated at the recomputed
    (u, v), the geometric normal cross(e1, e2) and the UVs, and the
    winner's values ride home in the payload; gradients reach the owning
    shard's soup through the hops' backward.

    Returns (HitRecord, shading normal (..., 3) not normalized, geometric
    normal (..., 3) unit, uv (..., 2))."""
    if soup.corner_normals is None:
        raise ValueError("ring shading needs shard_geometry(..., "
                         "with_shading=True)")
    D = mesh.size
    per = soup.num_prims
    batch = ray.batch_shape
    n = math.prod(batch)
    dev = ray.dir.device
    mt = torch.as_tensor(max_t, dtype=torch.float32, device=dev)
    mt = mt.expand(batch)
    best = HitRecord.none(batch, dev)
    owner = torch.zeros(batch, dtype=torch.int32, device=dev)
    # miss lanes keep a unit normal: normalize(0) would put NaNs into
    # masked products downstream (NaN * 0 = NaN)
    ns = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(batch + (3,))
    ng = ns
    uv = torch.zeros(batch + (2,), dtype=torch.float32, device=dev)
    for _ in range(D):
        tn, tf, bh = _cull(ray, shard_lo, shard_hi)
        bound = torch.minimum(best.t.detach(), mt)
        want = bh & (tf >= 0.0) & (tn < bound)
        hr = _local_closest(ray, soup, bvh, backend,
                            torch.where(want, bound, -1.0))
        closer = hr.hit & (hr.t < best.t) & (hr.t < mt)
        # the surface at this hop's winning triangle, from the local soup
        pid = torch.where(closer, hr.prim_id, 0)
        w = torch.stack([1.0 - hr.u - hr.v, hr.u, hr.v], dim=-1)
        ns_new = torch.sum(take(soup.corner_normals, pid) * w[..., None],
                           dim=-2)
        if soup.tex_coords is not None:
            uv_new = torch.sum(take(soup.tex_coords, pid) * w[..., None],
                               dim=-2)
        else:
            uv_new = uv
        # safe_normalize: lanes that lose this hop gather triangle 0, which
        # may be degenerate; normalize(0)'s backward would give them NaN
        ng_new = safe_normalize(cross(take(soup.e1, pid),
                                      take(soup.e2, pid)))

        def sel(a, b):
            return torch.where(closer, a, b)

        def sel3(a, b):
            return torch.where(closer[..., None], a, b)

        best = HitRecord(hit=best.hit | closer, t=sel(hr.t, best.t),
                         prim_id=sel(hr.prim_id, best.prim_id),
                         geom_id=sel(hr.geom_id, best.geom_id),
                         u=sel(hr.u, best.u), v=sel(hr.v, best.v))
        owner = torch.where(closer, mesh.rank, owner)
        ns, ng, uv = sel3(ns_new, ns), sel3(ng_new, ng), sel3(uv_new, uv)
        if D == 1:
            continue
        o, d, m, t, u, v, ns, ng, uv, ints = _ring_step(
            [_f(ray.ori, n), _f(ray.dir, n), _f(mt, n), _f(best.t, n),
             _f(best.u, n), _f(best.v, n), _f(ns, n), _f(ng, n),
             _f(uv, n),
             torch.stack([best.hit.float(), best.prim_id.float(),
                          best.geom_id.float(), owner.float()],
                         dim=-1).reshape(n, 4)], mesh)
        ints = ints.detach().round().to(torch.int32)
        ray = Ray(ori=o.reshape(batch + (3,)), dir=d.reshape(batch + (3,)))
        mt = m.detach().reshape(batch)
        best = HitRecord(hit=ints[:, 0].reshape(batch) > 0,
                         t=t.reshape(batch),
                         prim_id=ints[:, 1].reshape(batch),
                         geom_id=ints[:, 2].reshape(batch),
                         u=u.reshape(batch), v=v.reshape(batch))
        owner = ints[:, 3].reshape(batch)
        ns = ns.reshape(batch + (3,))
        ng = ng.reshape(batch + (3,))
        uv = uv.reshape(batch + (2,))
    best = dataclasses.replace(best, prim_id=torch.where(
        best.hit, owner * per + best.prim_id, 0))
    return best, ns, ng, uv


@torch.no_grad()
def ring_any_hit_local(ray: Ray, max_t, soup: SoupMesh, bvh, shard_lo,
                       shard_hi, backend: str, mesh: Mesh) -> HitRecord:
    """Occlusion over the ring: a ray found occluded takes no part in any
    later shard's trace.  No gradient (JAX stops it too)."""
    D = mesh.size
    batch = ray.batch_shape
    n = math.prod(batch)
    dev = ray.dir.device
    ray = Ray(ori=ray.ori.detach(), dir=ray.dir.detach())
    mt = torch.as_tensor(max_t, dtype=torch.float32,
                         device=dev).detach().expand(batch)
    occluded = torch.zeros(batch, dtype=torch.bool, device=dev)
    t = torch.full(batch, FLT_MAX, dtype=torch.float32, device=dev)
    for _ in range(D):
        tn, tf, bh = intersect_aabb(ray.ori, 1.0 / torch.where(
            torch.abs(ray.dir) < 1e-30, 1e-30, ray.dir), shard_lo, shard_hi)
        want = ~occluded & bh & (tf >= 0.0) & (tn < mt)
        hr = _local_any(ray, soup, bvh, backend, torch.where(want, mt, -1.0))
        occluded = occluded | hr.hit
        t = torch.where(hr.hit & (hr.t < t), hr.t, t)
        if D == 1:
            continue
        o, d, m, tt, occ = _ring_step(
            [_f(ray.ori, n), _f(ray.dir, n), _f(mt, n), _f(t, n),
             _f(occluded, n)], mesh)
        ray = Ray(ori=o.reshape(batch + (3,)), dir=d.reshape(batch + (3,)))
        mt, t = m.reshape(batch), tt.reshape(batch)
        occluded = occ.reshape(batch) > 0.5
    zi = torch.zeros(batch, dtype=torch.int32, device=dev)
    return HitRecord(hit=occluded, t=t, prim_id=zi, geom_id=zi,
                     u=torch.zeros_like(t), v=torch.zeros_like(t))


def _block(x, mesh: Mesh):
    """This rank's contiguous block of the flat leading axis of ``x``."""
    N = x.shape[0]
    if N % mesh.size:
        raise ValueError(f"{N} rays do not split over {mesh.size} ranks")
    per = N // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _local_shard(geo: ShardedGeometry, mesh: Mesh) -> Shard:
    if geo.num_shards != mesh.size:
        raise ValueError(f"{geo.num_shards} shards over {mesh.size} ranks: "
                         f"one shard a rank")
    return geo.local(mesh.rank)


def _gather_record(hr: HitRecord, mesh: Mesh) -> HitRecord:
    return HitRecord(**{f.name: all_gather(getattr(hr, f.name), mesh)
                        for f in dataclasses.fields(HitRecord)})


def geometry_sharded_closest_hit(ray_global: Ray, geo: ShardedGeometry,
                                 mesh: Mesh) -> HitRecord:
    """Every rank's entry: the global rays (N, 3), N divisible by the
    ranks, split into contiguous blocks, this rank's shard of ``geo``; the
    global HitRecord on every rank.  Differentiable with respect to the
    soup corners (this rank's block carries the graph; every rank must
    call ``backward()``)."""
    sh = _local_shard(geo, mesh)
    ray = Ray(ori=_block(ray_global.ori, mesh),
              dir=_block(ray_global.dir, mesh))
    hr = ring_closest_hit_local(ray, sh.soup, sh.bvh, sh.shard_lo,
                                sh.shard_hi, geo.backend, mesh)
    return _gather_record(hr, mesh)


def geometry_sharded_any_hit(ray_global: Ray, max_t, geo: ShardedGeometry,
                             mesh: Mesh) -> HitRecord:
    sh = _local_shard(geo, mesh)
    mt = torch.as_tensor(max_t, dtype=torch.float32,
                         device=ray_global.dir.device)
    mt = mt.expand(ray_global.batch_shape)
    ray = Ray(ori=_block(ray_global.ori, mesh),
              dir=_block(ray_global.dir, mesh))
    hr = ring_any_hit_local(ray, _block(mt, mesh), sh.soup, sh.bvh,
                            sh.shard_lo, sh.shard_hi, geo.backend, mesh)
    return _gather_record(hr, mesh)


def shard_mesh(mesh, n_shards: int) -> ShardedGeometry:
    """The round-1 name: spatial sharding with the brute-force backend."""
    return shard_geometry(mesh, n_shards, backend="brute")
