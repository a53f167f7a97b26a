"""Simple kernel: one closest-hit and direct shading per light, no shadows
(port of kernels/simple.py).

- closest_hit over the scene;
- ambient = material ambient * ambient_color;
- two-sided shading: n = faceforward(shading normal, view dir, geometric
  normal);
- per light: shade toward the light position, summed;
- color = hit ? rgba(shaded) : bg; depth = t.
"""

from __future__ import annotations

import torch

from visionaray_torch.core.types import Ray, ResultRecord
from visionaray_torch.core.vecmath import faceforward, normalize
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops.trace import closest_hit
from visionaray_torch.shading.lights import light_groups
from visionaray_torch.shading.surface import get_surface


def simple_kernel(params: KernelParams, ray: Ray,
                  sampler=None) -> ResultRecord:
    scene = params.scene
    hit_rec = closest_hit(ray, scene, hit_filter=params.hit_filter,
                          trace=params.trace)
    hit = hit_rec.hit[..., None]
    isect_pos = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))

    surf = get_surface(hit_rec, ray, scene)
    ambient = surf.materials.ambient() * params.ambient_color[:3]
    shaded = torch.where(hit, ambient,
                         params.bg_color[:3].expand(ambient.shape))

    view_dir = -ray.dir
    n = faceforward(surf.shading_normal, view_dir, surf.geometric_normal)

    for lights in light_groups(scene.lights):
        for li in range(lights.num_lights):
            light_dir = normalize(lights.position[li] - isect_pos)
            intensity = lights.intensity(li, isect_pos)
            clr = surf.materials.shade(n, view_dir, light_dir, intensity)
            shaded = shaded + torch.where(hit, clr, 0.0)

    rgba = torch.cat([shaded, torch.ones_like(shaded[..., :1])], dim=-1)
    color = torch.where(hit, rgba, params.bg_color)
    return ResultRecord(color=color, hit=hit_rec.hit, depth=hit_rec.t)
