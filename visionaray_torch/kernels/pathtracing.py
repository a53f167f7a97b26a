"""Iterative path tracing with lane masks and next-event estimation (port
of kernels/pathtracing.py).

The bounce loop is a Python loop; on a treelet-built ClusterBVH bounce 0
(coherent camera rays and their shadow rays) traces the whole tree and
bounces 1.. trace treelet-binned; any other tree traces every bounce
coherently.  Retired lanes carry max_t = -1 and never enter a traversal
tile.  ``params.trace`` (``TraceConfig``) picks how: NEE shadow segments
are traced from the light end (``shadow_reversed``, else from the
surface), through the binned path after bounce 0 (``shadow_binned``, else
coherently), as the JAX package's VSNRAY_SHADOW_REVERSED and
VSNRAY_SHADOW_BINNED switches do; its traversal fields reach every query.

Spectral mode (``shading/spectrum.py::lift_scene``): the color algebra is
channel-count agnostic, so the kernel reads the channel count nc from
``materials.cd``, lifts the ambient with ``from_rgb`` and folds the result
back through ``to_rgb`` before the alpha channel is added.

With autograd on, each bounce runs under a non-reentrant checkpoint: the
backward keeps only the bounce's carry and its traversal outputs (a
``TraceTape`` per bounce) and recomputes the rest of the body -- gathers,
shading, light sampling -- replaying the recorded traversals, so no kernel
launches in backward (JAX: jax.checkpoint with
save_only_these_names("traced_hits")).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from visionaray_torch.core.types import FLT_MAX, Ray, ResultRecord
from visionaray_torch.core.vecmath import faceforward, length
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import traverse
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import any_hit, closest_hit
from visionaray_torch.shading.lights import AreaLights, light_groups
from visionaray_torch.shading.spectrum import from_rgb, to_rgb
from visionaray_torch.shading.surface import get_surface


def _nee_direct(lights, nc, surf, n, view_dir, isect_pos, eps, ua, ub, ul,
                trace_any, mask=None, reversed_shadow: bool = True):
    """One-sample next-event estimate of the direct term at isect_pos:
    uniform light pick, area lights sampled over their surface with the
    cos_l * A / (pi r^2) factor.  Lanes outside ``mask``, facing away from
    the light or behind an area light fire no shadow ray (max_t = -1).
    ``reversed_shadow``: the shadow segment is traced from the light end,
    else from the surface."""
    groups = light_groups(lights)
    total = sum(g.num_lights for g in groups)
    batch = tuple(isect_pos.shape[:-1])
    dev = isect_pos.device
    if total == 0:
        return torch.zeros(batch + (nc,), dtype=torch.float32, device=dev)

    sel_idx = torch.clamp_max((ul * total).to(torch.int32), total - 1)
    P = torch.zeros(batch + (3,), dtype=torch.float32, device=dev)
    I = torch.zeros(batch + (nc,), dtype=torch.float32, device=dev)
    g = torch.ones(batch, dtype=torch.float32, device=dev)
    idx = 0
    for lgroup in groups:
        for li in range(lgroup.num_lights):
            sel = sel_idx == idx
            if isinstance(lgroup, AreaLights):
                P_l = lgroup.sample(li, ua, ub)
                to = P_l - isect_pos
                r2 = torch.clamp_min(torch.sum(to * to, dim=-1), 1e-12)
                wi_l = to / torch.sqrt(r2)[..., None]
                nl = lgroup.normal(li)
                cos_l = torch.clamp_min(-torch.sum(nl * wi_l, dim=-1), 0.0)
                g_l = cos_l * lgroup.area(li) / (math.pi * r2)
            else:
                P_l = lgroup.position[li].expand(batch + (3,))
                g_l = torch.ones(batch, dtype=torch.float32, device=dev)
            I_l = lgroup.intensity(li, isect_pos)
            P = torch.where(sel[..., None], P_l, P)
            I = torch.where(sel[..., None], I_l, I)
            g = torch.where(sel, g_l, g)
            idx += 1

    to_light = P - isect_pos
    dist = length(to_light)
    wi = to_light / torch.clamp_min(dist, 1e-12)[..., None]
    fire = (torch.sum(n * wi, dim=-1) > 0.0) & (g > 0.0)
    if mask is not None:
        fire = fire & mask
    mt = torch.where(fire, dist - 2.0 * eps, -1.0)
    if reversed_shadow:
        # from the light end: shadow rays of one light share (nearly) one
        # origin, so the batch is point-source coherent
        shadow = trace_any(Ray(ori=P - wi * eps, dir=-wi), mt)
    else:
        shadow = trace_any(Ray(ori=isect_pos + wi * eps, dir=wi), mt)
    visible = fire & ~shadow.hit
    direct = surf.materials.shade(n, view_dir, wi, I)
    return direct * (g * visible * float(total))[..., None]


def scene_tracer(params: KernelParams, binned: bool):
    """(closest, any) over the scene: closest_hit + get_surface.  The
    shadow query is binned only if ``params.trace.shadow_binned``."""
    scene = params.scene
    cfg = params.trace

    def trace_closest(ray, max_t):
        hr = closest_hit(ray, scene, binned=binned, max_t=max_t,
                         hit_filter=params.hit_filter, trace=cfg)
        return hr, get_surface(hr, ray, scene)

    def trace_any(ray, max_t):
        return any_hit(ray, scene, max_t=max_t,
                       binned=binned and cfg.shadow_binned,
                       hit_filter=params.hit_filter, trace=cfg)

    return trace_closest, trace_any


def _checkpointed(body):
    """``body`` under a checkpoint whose recompute replays the traversals
    recorded in its forward.  The sampler is counter-based, so no RNG
    state is kept."""
    def run(*args):
        tape = traverse.TraceTape()
        return checkpoint(
            body, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (traverse.recording(tape),
                                traverse.replaying(tape)))
    return run


def pathtrace_loop(ray: Ray, sampler: Sampler, *, num_bounces: int,
                   tracer, tracer0=None, lights, nc: int, amb3, bg_color,
                   eps, nee: bool,
                   reversed_shadow: bool = True,
                   recompute: bool = True) -> ResultRecord:
    """The bounce loop, generic over the tracer; ``tracer0`` (if given)
    handles bounce 0 only.  ``recompute``: under autograd, each bounce is
    checkpointed and recomputed in backward (replaying its traversals);
    the ring tracer of parallel/sharded_pt.py turns it off, since its
    traces are collective and must not run again in one rank's backward."""
    batch = ray.batch_shape
    dev = ray.dir.device
    amb3 = torch.as_tensor(amb3, dtype=torch.float32, device=dev)

    def bounce_body(tr, bounce, ray, sampler, active, dst, acc, first_hit,
                    first_t, prev_delta):
        trace_closest, trace_any = tr
        hit_rec, surf = trace_closest(ray, torch.where(active, FLT_MAX, -1.0))

        exited = active & ~hit_rec.hit
        if nee:
            acc = torch.where(exited[..., None], acc + dst * amb3, acc)
        else:
            dst = torch.where(exited[..., None], dst * amb3, dst)
        active = active & hit_rec.hit

        is_first = bounce == 0
        if is_first:
            first_hit = hit_rec.hit
            first_t = hit_rec.t

        view_dir = -ray.dir
        n = faceforward(surf.shading_normal, view_dir, surf.geometric_normal)

        if nee:
            (u_lobe, u1, u2, ul, ua, ub), sampler = sampler.next_n(6)
        else:
            (u_lobe, u1, u2), sampler = sampler.next_n(3)
        src, refl_dir, pdf = surf.materials.sample(n, view_dir, u_lobe, u1,
                                                   u2)
        zero_pdf = pdf <= 0.0
        emissive = surf.materials.is_emissive()

        if nee:
            isect_pos0 = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))
            # mirror lanes: shade() is 0, so their shadow ray is dropped
            take_d = active & ~emissive & ~surf.materials.is_specular()
            direct = _nee_direct(lights, nc, surf, n, view_dir, isect_pos0,
                                 eps, ua, ub, ul, trace_any, mask=take_d,
                                 reversed_shadow=reversed_shadow)
            acc = torch.where(take_d[..., None], acc + dst * direct, acc)
            # emission counts on the camera ray and after a delta bounce
            take_e = active & emissive & (is_first | prev_delta)
            acc = torch.where(take_e[..., None], acc + dst * src, acc)

        safe_pdf = torch.where(zero_pdf, 1.0, pdf)
        ndotwi = torch.sum(n * refl_dir, dim=-1)
        weight = torch.where(emissive, 1.0, ndotwi / safe_pdf)
        src = src * weight[..., None]

        upd = active & ~zero_pdf
        if nee:
            upd = upd & ~emissive
        dst = torch.where(upd[..., None], dst * src, dst)
        dst = torch.where((zero_pdf & active)[..., None], 0.0, dst)

        active = active & ~emissive & ~zero_pdf

        isect_pos = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))
        ray = Ray(ori=isect_pos + refl_dir * eps, dir=refl_dir)
        prev_delta = active & surf.materials.is_specular()
        return (ray, sampler, active, dst, acc, first_hit, first_t,
                prev_delta)

    step = _checkpointed(bounce_body) \
        if recompute and torch.is_grad_enabled() else bounce_body
    carry = (ray, sampler,
             torch.ones(batch, dtype=torch.bool, device=dev),
             torch.ones(batch + (nc,), dtype=torch.float32, device=dev),
             torch.zeros(batch + (nc,), dtype=torch.float32, device=dev),
             torch.zeros(batch, dtype=torch.bool, device=dev),
             torch.zeros(batch, dtype=torch.float32, device=dev),
             torch.zeros(batch, dtype=torch.bool, device=dev))
    for bounce in range(num_bounces):
        tr = tracer0 if (tracer0 is not None and bounce == 0) else tracer
        carry = step(tr, bounce, *carry)
    _, _, active, dst, acc, first_hit, first_t, _ = carry

    # paths still alive at loop end terminate to black
    out = acc if nee else torch.where(active[..., None], 0.0, dst)
    if nc != 3:
        # fold the spectrum through the CIE observer for display
        out = to_rgb(out)
    rgba = torch.cat([out, torch.ones_like(out[..., :1])], dim=-1)
    color = torch.where(first_hit[..., None], rgba,
                        torch.as_tensor(bg_color, dtype=torch.float32,
                                        device=dev))
    return ResultRecord(color=color, hit=first_hit, depth=first_t)


def pathtracing_kernel(params: KernelParams, ray: Ray, sampler: Sampler,
                       nee: bool = False) -> ResultRecord:
    scene = params.scene
    nc = scene.materials.cd.shape[-1]
    amb3 = params.ambient_color[:3]
    if nc != 3:
        amb3 = from_rgb(amb3, nc)
    has_treelets = scene.bvh is not None and \
        getattr(scene.bvh, "treelet_size", 0) > 0
    if has_treelets and params.num_bounces > 1:
        tracer0 = scene_tracer(params, binned=False)
        tracer = scene_tracer(params, binned=True)
    else:
        tracer0 = None
        tracer = scene_tracer(params, binned=False)
    return pathtrace_loop(
        ray, sampler, num_bounces=params.num_bounces, tracer=tracer,
        tracer0=tracer0, lights=scene.lights, nc=nc,
        amb3=amb3, bg_color=params.bg_color,
        eps=params.epsilon, nee=nee,
        reversed_shadow=params.trace.shadow_reversed)
