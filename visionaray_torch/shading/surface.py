"""get_surface: shading data at hit points (port of shading/surface.py):
geometric and shading normals, the texel color at the interpolated UVs
when the scene has textures, and the per-ray material rows."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from visionaray_torch.core.types import HitRecord, Ray
from visionaray_torch.core.vecmath import normalize
from visionaray_torch.device import take
from visionaray_torch.ops.trace import (
    PRIM_PLANE, PRIM_SPHERE, PRIM_TRIANGLE, prim_type_of,
)
from visionaray_torch.shading.materials import Materials
from visionaray_torch.shading.spectrum import from_rgb
from visionaray_torch.shading.texture import sample_scene_texture


@dataclass
class Surface:
    geometric_normal: Any  # (..., 3)
    shading_normal: Any    # (..., 3)
    tex_color: Any         # (..., 3)
    materials: Materials   # per-ray gathered material rows


def get_surface(hit: HitRecord, ray: Ray, scene) -> Surface:
    batch = tuple(hit.t.shape)
    dev = hit.t.device
    ptype = prim_type_of(scene, hit.prim_id)

    geom_n = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    shade_n = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    tex_color = torch.ones(batch + (3,), dtype=torch.float32, device=dev)

    nt = scene.num_triangles
    ns = scene.num_spheres

    if scene.mesh is not None:
        tri_idx = torch.clamp(hit.prim_id, 0, max(nt - 1, 0))
        tri_n = take(scene.mesh.normals, tri_idx)
        is_tri = (ptype == PRIM_TRIANGLE)[..., None]
        geom_n = torch.where(is_tri, tri_n, geom_n)
        if scene.mesh.face_normals_binding:
            tri_sn = tri_n
        else:
            cn = take(scene.mesh.corner_normals, tri_idx)
            w = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
            tri_sn = normalize(torch.sum(cn * w[..., None], dim=-2))
        shade_n = torch.where(is_tri, tri_sn, shade_n)
        if scene.textures is not None:
            uvs = take(scene.mesh.tex_coords, tri_idx)
            w = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
            uv = torch.sum(uvs * w[..., None], dim=-2)
            tc = sample_scene_texture(scene.textures, hit.geom_id, uv)
            tex_color = torch.where(is_tri, tc, tex_color)

    if scene.spheres is not None:
        sp_idx = torch.clamp(hit.prim_id - nt, 0, max(ns - 1, 0))
        center = take(scene.spheres.center, sp_idx)
        radius = take(scene.spheres.radius, sp_idx)
        isect_pos = ray.at(torch.where(hit.hit, hit.t, 1.0))
        sp_n = (isect_pos - center) / radius[..., None]
        is_sp = (ptype == PRIM_SPHERE)[..., None]
        geom_n = torch.where(is_sp, sp_n, geom_n)
        shade_n = torch.where(is_sp, sp_n, shade_n)

    if scene.planes is not None:
        pl_idx = torch.clamp(hit.prim_id - nt - ns, 0,
                             max(scene.num_planes - 1, 0))
        pl_n = take(scene.planes.normal, pl_idx)
        is_pl = (ptype == PRIM_PLANE)[..., None]
        geom_n = torch.where(is_pl, pl_n, geom_n)
        shade_n = torch.where(is_pl, pl_n, shade_n)

    mats = scene.materials.take(hit.geom_id)
    if scene.textures is not None:
        # the reference multiplies tex_color into every diffuse and
        # emissive term (matte.inl:64,141, plastic.inl:62,182,
        # emissive.inl:89); folded into the per-ray rows here, it reaches
        # shade(), sample() and NEE alike
        nc = mats.cd.shape[-1]
        tc = tex_color if nc == 3 else from_rgb(tex_color, nc)
        mats = dataclasses.replace(mats, cd=mats.cd * tc, ce=mats.ce * tc)
    return Surface(geometric_normal=geom_n, shading_normal=shade_n,
                   tex_color=tex_color, materials=mats)
