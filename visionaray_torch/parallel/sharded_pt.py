"""Path tracing over geometry-sharded scenes, BASELINE config #5 (port of
parallel/sharded_pt.py).

A scene too large to replicate on each card (instanced Sponza x16 at 4K)
is split spatially over the ranks (parallel/ring.py, ~1/D of the scene a
card), the image is split into blocks over the same ranks, and the whole
bounce loop runs on every rank:

- closest hit and surface: ``ring_closest_surface_local``: every hop
  traces the local tree and the winning hop gathers the shading data
  from its local soup; the winner rides the ring home;
- NEE shadow rays: ``ring_any_hit_local``, per-lane max_t, occluded
  lanes skip later shards;
- materials, lights and textures are replicated (kilobytes).

The bounce loop is ``kernels.pathtracing.pathtrace_loop``, the replicated
path's, with a ring tracer in place of the scene tracer, run without its
per-bounce recompute (a ring's traces are collective).

Gradients: each hop's closest hit is recompute-differentiable in the
local soup corners and the surface gather in the local corner normals,
so ``backward()`` of a loss over the frame, called on every rank, leaves
each rank's soup gradients (``soup_grads_to_faces`` maps them to faces)
and each rank's share of the replicated materials' and lights' gradients
(``tile_sharding.all_reduce_grads`` sums them).
"""

from __future__ import annotations

import dataclasses

import torch

from visionaray_torch.core.vecmath import normalize
from visionaray_torch.kernels.pathtracing import pathtrace_loop
from visionaray_torch.ops.sampling import Sampler, as_u32, pcg_hash
from visionaray_torch.parallel.comm import Mesh, all_gather
from visionaray_torch.parallel.ring import (
    Shard, ShardedGeometry, _local_shard, ring_any_hit_local,
    ring_closest_surface_local,
)
from visionaray_torch.sched.render import _pixel_grid
from visionaray_torch.shading.spectrum import from_rgb
from visionaray_torch.shading.surface import Surface


def ring_tracer(soup, bvh, shard_lo, shard_hi, backend: str, mesh: Mesh,
                materials, textures=None):
    """(closest, any) for ``pathtrace_loop`` over this rank's shard;
    ``materials`` and ``textures`` are the replicated tables."""

    def trace_closest(ray, max_t):
        hr, ns, ng, uv = ring_closest_surface_local(
            ray, soup, bvh, shard_lo, shard_hi, backend, mesh, max_t=max_t)
        mats = materials.take(hr.geom_id)
        tex_color = torch.ones(tuple(hr.t.shape) + (3,), dtype=torch.float32,
                               device=hr.t.device)
        if textures is not None:
            from visionaray_torch.shading.texture import sample_scene_texture
            tex_color = sample_scene_texture(textures, hr.geom_id, uv)
            tc = tex_color
            if mats.cd.shape[-1] != 3:   # spectral mode
                tc = from_rgb(tc, mats.cd.shape[-1])
            # as shading/surface.py: the texel modulates the diffuse and
            # emissive terms
            mats = dataclasses.replace(mats, cd=mats.cd * tc,
                                       ce=mats.ce * tc)
        surf = Surface(geometric_normal=ng, shading_normal=normalize(ns),
                       tex_color=tex_color, materials=mats)
        return hr, surf

    def trace_any(ray, max_t):
        return ring_any_hit_local(ray, max_t, soup, bvh, shard_lo, shard_hi,
                                  backend, mesh)

    return trace_closest, trace_any


def pathtrace_pixels_sharded(shard: Shard, materials, lights, x, y, cam,
                             width: int, height: int, *, mesh: Mesh,
                             num_bounces: int, spp: int = 1,
                             eps: float = 1e-3,
                             bg_color=(0.0, 0.0, 0.0, 1.0),
                             ambient=(1.0, 1.0, 1.0),
                             frame_num=1, seed: int = 0, nee: bool = True,
                             textures=None, backend: str = "lbvh"):
    """One rank's body: path trace its pixel block ``x``, ``y`` against its
    ``shard``.  Sampler keys are absolute pixel ids (y * width + x), so
    the frame does not depend on the number of ranks; it matches
    sched/render.py::render_pixels draw for draw."""
    tracer = ring_tracer(shard.soup, shard.bvh, shard.shard_lo,
                         shard.shard_hi, backend, mesh, materials, textures)
    dev = x.device
    nc = materials.cd.shape[-1]
    amb3 = torch.as_tensor(ambient[:3], dtype=torch.float32, device=dev)
    if nc != 3:
        amb3 = from_rgb(amb3, nc)
    pixel_id = (as_u32(y) * (width & 0xFFFFFFFF) + as_u32(x)) & 0xFFFFFFFF
    color = torch.zeros(tuple(x.shape) + (4,), dtype=torch.float32,
                        device=dev)
    depth = torch.zeros(tuple(x.shape), dtype=torch.float32, device=dev)
    for s in range(spp):
        stream = pcg_hash((seed + s * 0x85EBCA6B) & 0xFFFFFFFF)
        samp = Sampler.seed(0, pixel_id ^ stream.to(dev),
                            as_u32(frame_num, dev))
        (jx, jy), samp = samp.next_n(2)
        jitter = torch.stack([jx - 0.5, jy - 0.5], dim=-1)
        ray = cam.primary_rays(x, y, width, height, jitter)
        rec = pathtrace_loop(
            ray, samp, num_bounces=num_bounces, tracer=tracer, tracer0=None,
            lights=lights, amb3=amb3,
            bg_color=torch.as_tensor(bg_color, dtype=torch.float32,
                                     device=dev),
            eps=eps, nee=nee, recompute=False)
        color = color + rec.color
        depth = depth + torch.where(rec.hit, rec.depth, 0.0)
    return color / spp, depth / spp


def render_image_geometry_sharded(geo: ShardedGeometry, materials, lights,
                                  cam, width: int, height: int,
                                  mesh: Mesh, *, num_bounces: int = 5,
                                  spp: int = 1, eps: float = 1e-3,
                                  bg_color=(0.0, 0.0, 0.0, 1.0),
                                  ambient=(1.0, 1.0, 1.0),
                                  frame_num: int = 1, seed: int = 0,
                                  nee: bool = True, textures=None):
    """Config #5's frame, geometry- and tile-sharded; every rank calls it
    with its shard in ``geo`` and gets the whole (color (H, W, 4), depth
    (H, W)).  Differentiable with respect to the soup leaves, materials
    and lights (every rank must call ``backward()``)."""
    shard = _local_shard(geo, mesh)
    D = mesh.size
    n = width * height
    npad = -(-n // D) * D
    x, y = _pixel_grid(width, height, shard.soup.v1.device)
    pad = torch.zeros(npad - n, dtype=x.dtype, device=x.device)
    x, y = torch.cat([x, pad]), torch.cat([y, pad])
    per = npad // D
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    color, depth = pathtrace_pixels_sharded(
        shard, materials, lights, x[sl], y[sl], cam, width, height,
        mesh=mesh, num_bounces=num_bounces, spp=spp, eps=eps,
        bg_color=bg_color, ambient=ambient, frame_num=frame_num, seed=seed,
        nee=nee, textures=textures, backend=geo.backend)
    color, depth = all_gather(color, mesh), all_gather(depth, mesh)
    return (color[:n].reshape(height, width, 4),
            depth[:n].reshape(height, width))


def soup_grads_to_faces(grad_soup_field, prim_ids, num_faces: int):
    """Scatter-add per-shard soup gradients (S, per, ...) back to face
    order through ``prim_ids`` (S, per).  Padding slots (the repeated tail
    face) add into their source face: the duplicate is the same face."""
    flat = grad_soup_field.reshape((-1,) + tuple(grad_soup_field.shape[2:]))
    ids = prim_ids.reshape(-1).long()
    out = torch.zeros((num_faces,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    return out.index_add_(0, ids, flat)
