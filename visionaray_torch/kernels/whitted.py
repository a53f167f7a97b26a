"""Whitted ray tracing with shadows and specular bounces (port of
kernels/whitted.py).

- bounce loop of ``num_bounces`` iterations with lane masks (a Python
  loop: every iteration launches its traversals, as JAX's fori_loop runs
  every iteration);
- per light: a shadow ray offset by epsilon, any_hit(max_t = distance to
  the light);
- per bounce: color += (ambient + sum over lights of shade) * throughput;
- specular bounce direction = reflect(view_dir, shading normal) (not the
  two-sided n), throughput *= kr (matte 0, mirror kr, else 0.1);
- no-hit colour: the background on the first segment only.

Lanes that fire no shadow ray, or whose reflection carries no weight,
trace with max_t = -1: the traversal treats them as dead.
"""

from __future__ import annotations

import torch

from visionaray_torch.core.types import FLT_MAX, Ray, ResultRecord
from visionaray_torch.core.vecmath import faceforward, length, normalize
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops.trace import any_hit, closest_hit
from visionaray_torch.shading.lights import light_groups
from visionaray_torch.shading.surface import get_surface


def whitted_kernel(params: KernelParams, ray: Ray,
                   sampler=None) -> ResultRecord:
    scene = params.scene
    eps = params.epsilon
    bg3 = params.bg_color[:3]
    batch = ray.batch_shape
    dev = ray.dir.device
    kw = dict(hit_filter=params.hit_filter, trace=params.trace)

    hit_rec = closest_hit(ray, scene, **kw)
    first_hit, first_t = hit_rec.hit, hit_rec.t
    color = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    throughput = torch.ones(batch, dtype=torch.float32, device=dev)
    active = first_hit
    no_hit_scale = 1.0
    for _ in range(params.num_bounces):
        live = active & (throughput > eps)
        isect_pos = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))
        surf = get_surface(hit_rec, ray, scene)
        view_dir = -ray.dir
        n = faceforward(surf.shading_normal, view_dir, surf.geometric_normal)

        hit3 = hit_rec.hit[..., None]
        ambient = surf.materials.ambient() * params.ambient_color[:3]
        shaded = torch.where(hit3, ambient, bg3.expand(ambient.shape))
        fire = live & hit_rec.hit
        for lights in light_groups(scene.lights):
            for li in range(lights.num_lights):
                to_light = lights.position[li] - isect_pos
                light_dir = normalize(to_light)
                shadow_ray = Ray(ori=isect_pos + light_dir * eps,
                                 dir=light_dir)
                shadow_rec = any_hit(
                    shadow_ray, scene,
                    max_t=torch.where(fire, length(to_light), -1.0), **kw)
                lit = fire & ~shadow_rec.hit
                intensity = lights.intensity(li, isect_pos)
                clr = surf.materials.shade(n, view_dir, light_dir, intensity)
                shaded = shaded + torch.where(lit[..., None], clr, 0.0)

        seg = torch.where(hit3, shaded, no_hit_scale * bg3)
        color = color + torch.where(live[..., None],
                                    seg * throughput[..., None], 0.0)

        refl_dir, kr = surf.materials.specular_bounce(view_dir,
                                                      surf.shading_normal)
        ray = Ray(ori=isect_pos + refl_dir * eps, dir=refl_dir)
        throughput = torch.where(live, throughput * kr, throughput)
        cont = live & (throughput > eps)
        hit_rec = closest_hit(ray, scene,
                              max_t=torch.where(cont, FLT_MAX, -1.0), **kw)
        active = live & hit_rec.hit
        no_hit_scale = 0.0

    rgba = torch.cat([color, torch.ones_like(color[..., :1])], dim=-1)
    out = torch.where(first_hit[..., None], rgba, params.bg_color)
    return ResultRecord(color=out, hit=first_hit, depth=first_t)
