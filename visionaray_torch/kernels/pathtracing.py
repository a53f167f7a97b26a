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

``pathtracing_kernel`` picks one of two paths by what it is given.  With
autograd off, on a triangle scene with a flat LBVH-tier tree, no
textures, RGB colour, no hit filter and point lights only (``_fused_ok``),
a bounce is the closest walk, the hit kernel, the shadow walk and the
close kernel (``_fused_body``, ops/bounce_shade.py: the torch body's
operations between the walks in two hand-written CUDA kernels; their plain
versions on the CPU).  Every other input takes the torch body,
``pathtrace_loop``, which autograd, its recompute and the ring tracer of
parallel/sharded_pt.py need.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from visionaray_torch.core.types import FLT_MAX, Ray, ResultRecord
from visionaray_torch.core.vecmath import faceforward, length
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import bounce_shade, traversal, traverse
from visionaray_torch.ops.lbvh import BVH
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import any_hit, closest_hit
from visionaray_torch.shading.lights import (
    AreaLights, PointLights, light_groups,
)
from visionaray_torch.shading.spectrum import from_rgb, to_rgb
from visionaray_torch.shading.surface import get_surface
from visionaray_torch.utils import metrics


def _nee_direct(lights, nc, surf, n, view_dir, isect_pos, eps, ua, ub, ul,
                trace_any, mask=None, reversed_shadow: bool = True,
                bounce=None):
    """One-sample next-event estimate of the direct term at isect_pos:
    uniform light pick, area lights sampled over their surface with the
    cos_l * A / (pi r^2) factor.  Lanes outside ``mask``, facing away from
    the light or behind an area light fire no shadow ray (max_t = -1).
    ``reversed_shadow``: the shadow segment is traced from the light end,
    else from the surface.  The lanes that fire count in
    ``bounce.shadow[bounce]`` (utils/metrics.py)."""
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
    metrics.count("bounce.shadow", fire, bounce)
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


@contextlib.contextmanager
def _recompute(tape):
    """The recompute's context: ``tape``'s traversals replayed, and the
    spans inside marked as the recompute's (utils/metrics.py)."""
    with traverse.replaying(tape), metrics.recomputing():
        yield


def _checkpointed(body):
    """``body`` under a checkpoint whose recompute replays the traversals
    recorded in its forward.  The sampler is counter-based, so no RNG
    state is kept."""
    def run(*args):
        tape = traverse.TraceTape()
        return checkpoint(
            body, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (traverse.recording(tape), _recompute(tape)))
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
    traces are collective and must not run again in one rank's backward.

    Spans (utils/metrics.py), tagged ``bounce=b``, tile each bounce in
    order: ``bounce.closest`` (the closest walk with the hit record and
    surface gathers), ``bounce.shade`` (the hit's bookkeeping, samples and
    the material sample), ``bounce.nee`` (the light sample and shadow
    walk), ``bounce.shade`` again (weights, carry updates, the next ray);
    without NEE, closest and the two shade spans back to back.  Counters: ``bounce.lanes[b]``
    (lanes handed to the closest walk), ``bounce.live[b]`` (those with
    ``active``, the walk's max_t > 0), ``bounce.shadow[b]`` (lanes firing
    a shadow ray)."""
    batch = ray.batch_shape
    dev = ray.dir.device
    amb3 = torch.as_tensor(amb3, dtype=torch.float32, device=dev)

    def bounce_body(tr, bounce, ray, sampler, active, dst, acc, first_hit,
                    first_t, prev_delta):
        trace_closest, trace_any = tr
        metrics.count("bounce.lanes", active.numel(), bounce)
        metrics.count("bounce.live", active, bounce)
        with metrics.span("bounce.closest", bounce=bounce):
            hit_rec, surf = trace_closest(ray, torch.where(active, FLT_MAX,
                                                           -1.0))

        with metrics.span("bounce.shade", bounce=bounce):
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
            n = faceforward(surf.shading_normal, view_dir,
                            surf.geometric_normal)

            if nee:
                (u_lobe, u1, u2, ul, ua, ub), sampler = sampler.next_n(6)
            else:
                (u_lobe, u1, u2), sampler = sampler.next_n(3)
            src, refl_dir, pdf = surf.materials.sample(n, view_dir, u_lobe,
                                                       u1, u2)
            zero_pdf = pdf <= 0.0
            emissive = surf.materials.is_emissive()

            if nee:
                isect_pos0 = ray.at(torch.where(hit_rec.hit, hit_rec.t, 1.0))
                # mirror lanes: shade() is 0, so their shadow ray is dropped
                take_d = active & ~emissive & ~surf.materials.is_specular()

        if nee:
            with metrics.span("bounce.nee", bounce=bounce):
                direct = _nee_direct(lights, nc, surf, n, view_dir,
                                     isect_pos0, eps, ua, ub, ul, trace_any,
                                     mask=take_d,
                                     reversed_shadow=reversed_shadow,
                                     bounce=bounce)

        with metrics.span("bounce.shade", bounce=bounce):
            if nee:
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


def _fused_ok(params: KernelParams) -> bool:
    """Whether ``pathtracing_kernel`` can run the bounce as two hand kernels
    around the LBVH walks (``_fused_body``): autograd is off, the scene is
    triangles alone on a flat ``ops.lbvh.BVH`` (LBVH, SAH or SBVH: what
    ``bvh_traverse`` walks), with no textures, RGB colour, no hit filter
    and point lights only.  Anything else takes the torch body."""
    scene = params.scene
    return (not torch.is_grad_enabled()
            and isinstance(scene.bvh, BVH) and scene.mesh is not None
            and scene.spheres is None and scene.planes is None
            and scene.textures is None and params.hit_filter is None
            and scene.materials.cd.shape[-1] == 3
            and all(isinstance(g, PointLights)
                    for g in light_groups(scene.lights)))


def _fused_body(params: KernelParams, ray: Ray, sampler: Sampler,
                nee: bool) -> ResultRecord:
    """The bounce loop as four launches a bounce (three without NEE): the
    closest walk, ``ops/bounce_shade.py::shade_hit``, the shadow walk and
    ``shade_close``, on flat lanes; the carry means what
    ``pathtrace_loop``'s does, and the result is its result.  Spans and
    counters as ``pathtrace_loop``'s: ``bounce.closest`` holds the closest
    walk, ``bounce.shade`` the hit kernel, ``bounce.nee`` the shadow walk,
    ``bounce.shade`` the close kernel; ``bounce.shadow`` counts the hit
    kernel's ``fire``."""
    scene = params.scene
    batch = ray.batch_shape
    dev = ray.dir.device
    o = ray.ori.reshape(-1, 3).to(torch.float32).contiguous()
    d = ray.dir.reshape(-1, 3).to(torch.float32).contiguous()
    n = o.shape[0]
    state = sampler.state.reshape(-1).contiguous()
    tables = traversal.prim_tables("triangle", scene.mesh)
    sh = bounce_shade.Shading.of(params, nee)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    dst = torch.ones((n, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    first_hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    first_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    prev_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
    max_t = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    for bounce in range(params.num_bounces):
        metrics.count("bounce.lanes", n, bounce)
        metrics.count("bounce.live", active, bounce)
        with metrics.span("bounce.closest", bounce=bounce):
            _, ref = traversal.bvh_traverse(o, d, max_t, scene.bvh,
                                            "triangle", tables, "closest")
        with metrics.span("bounce.shade", bounce=bounce):
            hit = bounce_shade.shade_hit(sh, o, d, ref, state, active, dst,
                                         acc, bounce)
        shadow_ref = None
        if nee:
            acc = hit.carry
            with metrics.span("bounce.nee", bounce=bounce):
                if hit.fire is not None:
                    metrics.count("bounce.shadow", hit.fire, bounce)
                    _, shadow_ref = traversal.bvh_traverse(
                        hit.shadow_o, hit.shadow_d, hit.shadow_t, scene.bvh,
                        "triangle", tables, "any")
        else:
            dst = hit.carry
        with metrics.span("bounce.shade", bounce=bounce):
            nxt = bounce_shade.shade_close(sh, d, hit, shadow_ref, dst, acc,
                                           prev_delta, bounce)
        if bounce == 0:
            first_hit, first_t = hit.first_hit, hit.first_t
        state = hit.state
        o, d, max_t = nxt.o, nxt.d, nxt.max_t
        dst, acc, active, prev_delta = (nxt.dst, nxt.acc, nxt.active,
                                        nxt.prev_delta)

    out = acc if nee else torch.where(active[..., None], 0.0, dst)
    rgba = torch.cat([out, torch.ones_like(out[..., :1])], dim=-1)
    color = torch.where(first_hit[..., None], rgba,
                        torch.as_tensor(params.bg_color, dtype=torch.float32,
                                        device=dev))
    return ResultRecord(color=color.reshape(batch + (4,)),
                        hit=first_hit.reshape(batch),
                        depth=first_t.reshape(batch))


def _torch_body(params: KernelParams, ray: Ray, sampler: Sampler,
                nee: bool) -> ResultRecord:
    """``pathtrace_loop`` over the scene's tracers."""
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


def pathtracing_kernel(params: KernelParams, ray: Ray, sampler: Sampler,
                       nee: bool = False) -> ResultRecord:
    """Path-traced colour, first hit and depth of ``ray``: through
    ``_fused_body`` where ``_fused_ok`` holds, else the torch body."""
    if _fused_ok(params):
        return _fused_body(params, ray, sampler, nee)
    return _torch_body(params, ray, sampler, nee)
