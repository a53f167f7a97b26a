"""Ambient-occlusion kernel (port of kernels/ao.py).

Per sample: a closest hit, then AO_SAMPLES cosine-distributed occlusion
rays with any_hit(max_t = radius, AO_RADIUS_SCALE of the scene diagonal),
drawn from the sampler two uniforms each in the reference's order; AO =
the unoccluded fraction.  Missed lanes fire no occlusion ray (max_t = -1).
Progressive accumulation is the scheduler's (jittered_blend).
"""

from __future__ import annotations

import torch

from visionaray_torch.core.types import Ray, ResultRecord
from visionaray_torch.core.vecmath import (
    faceforward, normalize, orthonormal_basis,
)
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import any_hit, closest_hit
from visionaray_torch.shading.brdf import cosine_sample_hemisphere
from visionaray_torch.shading.surface import get_surface

AO_SAMPLES = 8
AO_RADIUS_SCALE = 0.1   # fraction of the scene diagonal


def ao_kernel(params: KernelParams, ray: Ray,
              sampler: Sampler) -> ResultRecord:
    scene = params.scene
    eps = params.epsilon
    kw = dict(hit_filter=params.hit_filter, trace=params.trace)
    hit_rec = closest_hit(ray, scene, **kw)
    surf = get_surface(hit_rec, ray, scene)
    view_dir = -ray.dir
    n = faceforward(surf.shading_normal, view_dir, surf.geometric_normal)
    isect_pos = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))

    bbox = scene.bbox()
    radius = AO_RADIUS_SCALE * torch.linalg.norm(bbox.hi - bbox.lo)
    max_t = torch.where(hit_rec.hit, radius, -1.0)
    u, v = orthonormal_basis(n)

    total = torch.zeros(hit_rec.t.shape, dtype=torch.float32,
                        device=ray.dir.device)
    samp = sampler
    for _ in range(AO_SAMPLES):
        (u1, u2), samp = samp.next_n(2)
        sp = cosine_sample_hemisphere(u1, u2)
        dir = normalize(sp[..., 0:1] * u + sp[..., 1:2] * v
                        + sp[..., 2:3] * n)
        occ = any_hit(Ray(ori=isect_pos + dir * eps, dir=dir), scene,
                      max_t=max_t, **kw)
        total = total + torch.where(hit_rec.hit & ~occ.hit, 1.0, 0.0)
    ao = total / AO_SAMPLES

    c = ao[..., None].expand(ao.shape + (3,))
    rgba = torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)
    color = torch.where(hit_rec.hit[..., None], rgba, params.bg_color)
    return ResultRecord(color=color, hit=hit_rec.hit, depth=hit_rec.t)
