"""The shading of one path-tracing bounce between its two walks, stated once
for the torch body (kernels/pathtracing.py::_bounce_body) and the plain
versions of the two shading kernels (ops/bounce_shade.py): after the
closest walk ``at_hit`` and, with NEE, ``light_sample``; after the shadow
walk ``direct_light`` and ``next_ray``.  The pieces open no span and
count nothing: their callers do."""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from visionaray_torch.core.types import Ray
from visionaray_torch.core.vecmath import faceforward, length
from visionaray_torch.shading.lights import AreaLights, light_groups


class Shade(NamedTuple):
    """A bounce's state between its walks, what ``mid`` packs: the
    faceforward normal, the view direction, the material sample's colour,
    direction and pdf, the hit point, the lane masks (``take_d``: the
    direct term's lanes, NEE only) and the material rows; with NEE, the
    sampler's light draws and, once a light is picked, its direction,
    intensity and area factor, the lanes that fire and the lights'
    count."""

    n: torch.Tensor
    view_dir: torch.Tensor
    src: torch.Tensor
    refl_dir: torch.Tensor
    pdf: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    emissive: torch.Tensor
    specular: torch.Tensor
    zero_pdf: torch.Tensor
    take_d: Optional[torch.Tensor] = None
    mats: Any = None
    sampler: Any = None
    u_light: Optional[list] = None
    wi: Optional[torch.Tensor] = None
    I: Optional[torch.Tensor] = None
    g: Optional[torch.Tensor] = None
    fire: Optional[torch.Tensor] = None
    total: int = 0


def at_hit(hit_rec, surf, ray: Ray, sampler, active, dst, acc, *, amb,
           nee: bool):
    """From the closest walk's record and surface: the ambient term of the
    lanes that exit (into ``acc`` with NEE, else ``dst``), the sampler's 3
    draws (6 with NEE), ``Materials.sample``, the masks and the hit point.
    Returns ``(Shade, dst, acc)``."""
    exited = active & ~hit_rec.hit
    if nee:
        acc = torch.where(exited[..., None], acc + dst * amb, acc)
    else:
        dst = torch.where(exited[..., None], dst * amb, dst)
    active = active & hit_rec.hit

    view_dir = -ray.dir
    n = faceforward(surf.shading_normal, view_dir, surf.geometric_normal)
    u_light = None
    if nee:
        (u_lobe, u1, u2, *u_light), sampler = sampler.next_n(6)
    else:
        (u_lobe, u1, u2), sampler = sampler.next_n(3)
    src, refl_dir, pdf = surf.materials.sample(n, view_dir, u_lobe, u1, u2)
    emissive = surf.materials.is_emissive()
    specular = surf.materials.is_specular()
    # mirror lanes: shade() is 0, so their shadow ray is dropped
    take_d = active & ~emissive & ~specular if nee else None
    pos = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))
    return Shade(n=n, view_dir=view_dir, src=src, refl_dir=refl_dir,
                 pdf=pdf, pos=pos, active=active, emissive=emissive,
                 specular=specular, zero_pdf=pdf <= 0.0, take_d=take_d,
                 mats=surf.materials, sampler=sampler,
                 u_light=u_light), dst, acc


def light_sample(lights, h: Shade, eps, *, reversed_shadow: bool):
    """NEE up to its shadow walk, one sample: a uniform light pick, area
    lights sampled over their surface with the cos_l * A / (pi r^2)
    factor.  Lanes outside ``h.take_d``, facing away from the light or
    behind an area light fire no shadow ray (max_t = -1).
    ``reversed_shadow``: the segment is traced from the light end, else
    from the surface.  Returns ``(h with the light, shadow ray, max_t)``;
    ``(h, None, None)`` without lights."""
    groups = light_groups(lights)
    total = sum(g.num_lights for g in groups)
    if total == 0:
        return h, None, None
    ul, ua, ub = h.u_light
    pos = h.pos
    batch = tuple(pos.shape[:-1])
    dev = pos.device
    sel_idx = torch.clamp_max((ul * total).to(torch.int32), total - 1)
    P = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    I = torch.zeros(batch + (h.src.shape[-1],), dtype=torch.float32,
                    device=dev)
    g = torch.ones(batch, dtype=torch.float32, device=dev)
    idx = 0
    for lgroup in groups:
        for li in range(lgroup.num_lights):
            sel = sel_idx == idx
            if isinstance(lgroup, AreaLights):
                P_l = lgroup.sample(li, ua, ub)
                to = P_l - pos
                r2 = torch.clamp_min(torch.sum(to * to, dim=-1), 1e-12)
                wi_l = to / torch.sqrt(r2)[..., None]
                nl = lgroup.normal(li)
                cos_l = torch.clamp_min(-torch.sum(nl * wi_l, dim=-1), 0.0)
                g_l = cos_l * lgroup.area(li) / (math.pi * r2)
            else:
                P_l = lgroup.position[li].expand(batch + (3,))
                g_l = torch.ones(batch, dtype=torch.float32, device=dev)
            I_l = lgroup.intensity(li, pos)
            P = torch.where(sel[..., None], P_l, P)
            I = torch.where(sel[..., None], I_l, I)
            g = torch.where(sel, g_l, g)
            idx += 1

    to_light = P - pos
    dist = length(to_light)
    wi = to_light / torch.clamp_min(dist, 1e-12)[..., None]
    fire = (torch.sum(h.n * wi, dim=-1) > 0.0) & (g > 0.0)
    fire = fire & h.take_d
    mt = torch.where(fire, dist - 2.0 * eps, -1.0)
    if reversed_shadow:
        # from the light end: shadow rays of one light share (nearly) one
        # origin, so the batch is point-source coherent
        shadow = Ray(ori=P - wi * eps, dir=-wi)
    else:
        shadow = Ray(ori=pos + wi * eps, dir=wi)
    return h._replace(wi=wi, I=I, g=g, fire=fire, total=total), shadow, mt


def direct_light(h: Shade, occluded):
    """NEE after its shadow walk: ``shade()`` towards the picked light
    where it fired and the walk found nothing (``occluded`` False), times
    its factor and the lights' count; zero without lights."""
    if h.fire is None:
        return torch.zeros_like(h.src)
    visible = h.fire & ~occluded
    direct = h.mats.shade(h.n, h.view_dir, h.wi, h.I)
    return direct * (h.g * visible * float(h.total))[..., None]


def next_ray(h: Shade, direct, dst, acc, prev_delta, *, eps, nee: bool,
             first: bool):
    """From the direct term (NEE) to the next ray: the acc / dst updates,
    the BRDF weight, ``active`` and the ray from the hit point; ``first``:
    bounce 0.  Returns ``(ray, active, dst, acc, prev_delta)``."""
    if nee:
        acc = torch.where(h.take_d[..., None], acc + dst * direct, acc)
        # emission counts on the camera ray and after a delta bounce
        take_e = h.active & h.emissive & (first | prev_delta)
        acc = torch.where(take_e[..., None], acc + dst * h.src, acc)

    safe_pdf = torch.where(h.zero_pdf, 1.0, h.pdf)
    ndotwi = torch.sum(h.n * h.refl_dir, dim=-1)
    weight = torch.where(h.emissive, 1.0, ndotwi / safe_pdf)
    src = h.src * weight[..., None]

    upd = h.active & ~h.zero_pdf
    if nee:
        upd = upd & ~h.emissive
    dst = torch.where(upd[..., None], dst * src, dst)
    dst = torch.where((h.zero_pdf & h.active)[..., None], 0.0, dst)

    active = h.active & ~h.emissive & ~h.zero_pdf
    ray = Ray(ori=h.pos + h.refl_dir * eps, dir=h.refl_dir)
    return ray, active, dst, acc, active & h.specular
