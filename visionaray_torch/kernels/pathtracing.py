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

With autograd on, each bounce of the torch body runs under a
non-reentrant checkpoint: the backward keeps only the bounce's carry and
its traversal outputs (a ``TraceTape`` per bounce) and recomputes the rest
of the body -- gathers, shading, light sampling -- replaying the recorded
traversals, so no kernel launches in backward (JAX: jax.checkpoint with
save_only_these_names("traced_hits")).

``pathtracing_kernel`` picks one of two paths by what it is given.  On a
triangle scene with a flat LBVH-tier tree, no textures, RGB colour, no hit
filter and point lights only (``_fused_ok``), a bounce is the closest
walk, the hit kernel, the shadow walk and the close kernel
(``_fused_bounce``, ops/bounce_shade.py: the torch body's operations
between the walks, shading/bounce.py, in two hand-written CUDA kernels;
on the CPU, those operations themselves).  With autograd on, each such
bounce is one autograd node (``_FusedBounce``): its forward is those
launches, recording the walks on a ``TraceTape``; its backward, on the
card where the gradients asked for are the ray's, the carry's, the
vertices' and the albedo's (``_adjoint_ok``), is one launch of the
pair's adjoint kernel (``bounce_shade.shade_backward``), and otherwise
the checkpoint's recompute, the torch body's bounce replaying the walks,
which is also the adjoint's plain version.
Every other input takes the torch body, ``pathtrace_loop``, which the
ring tracer of parallel/sharded_pt.py needs too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from visionaray_torch.core.types import FLT_MAX, Ray, ResultRecord
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import bounce_shade, traversal, traverse
from visionaray_torch.ops.lbvh import BVH
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import any_hit, closest_hit
from visionaray_torch.shading import bounce as shade
from visionaray_torch.shading.lights import PointLights, light_groups
from visionaray_torch.shading.spectrum import from_rgb, to_rgb
from visionaray_torch.shading.surface import get_surface
from visionaray_torch.utils import metrics


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


def _bounce_body(*, lights, amb3, eps, nee: bool, reversed_shadow: bool):
    """``pathtrace_loop``'s bounce, the torch body: ``bounce_body(tr,
    bounce, ray, sampler, active, dst, acc, first_hit, first_t,
    prev_delta)`` -> the carry after bounce ``bounce``, through the
    tracers ``tr`` = (closest, any): the closest walk, the shading
    between the walks (shading/bounce.py) and the shadow walk; ``amb3`` a
    tensor on the rays' device."""
    def bounce_body(tr, bounce, ray, sampler, active, dst, acc, first_hit,
                    first_t, prev_delta):
        trace_closest, trace_any = tr
        metrics.count("bounce.lanes", active.numel(), bounce)
        metrics.count("bounce.live", active, bounce)
        with metrics.span("bounce.closest", bounce=bounce):
            hit_rec, surf = trace_closest(ray, torch.where(active, FLT_MAX,
                                                           -1.0))

        with metrics.span("bounce.shade", bounce=bounce):
            h, dst, acc = shade.at_hit(hit_rec, surf, ray, sampler, active,
                                       dst, acc, amb=amb3, nee=nee)
            if bounce == 0:
                first_hit, first_t = hit_rec.hit, hit_rec.t

        direct = None
        if nee:
            with metrics.span("bounce.nee", bounce=bounce):
                h, shadow, mt = shade.light_sample(
                    lights, h, eps, reversed_shadow=reversed_shadow)
                occluded = None
                if shadow is not None:
                    metrics.count("bounce.shadow", h.fire, bounce)
                    occluded = trace_any(shadow, mt).hit
                direct = shade.direct_light(h, occluded)

        with metrics.span("bounce.shade", bounce=bounce):
            ray, active, dst, acc, prev_delta = shade.next_ray(
                h, direct, dst, acc, prev_delta, eps=eps, nee=nee,
                first=bounce == 0)
        return (ray, h.sampler, active, dst, acc, first_hit, first_t,
                prev_delta)

    return bounce_body


def pathtrace_loop(ray: Ray, sampler: Sampler, *, num_bounces: int,
                   tracer, tracer0=None, lights, amb3, bg_color, eps,
                   nee: bool, reversed_shadow: bool = True,
                   recompute: bool = True) -> ResultRecord:
    """The bounce loop, generic over the tracer; ``tracer0`` (if given)
    handles bounce 0 only.  ``amb3``: the ambient colour in the
    materials' channels.  ``recompute``: under autograd, each bounce is
    checkpointed and recomputed in backward (replaying its traversals);
    the ring tracer of parallel/sharded_pt.py turns it off, since its
    traces are collective and must not run again in one rank's backward.

    Spans (utils/metrics.py), tagged ``bounce=b``, tile each bounce in
    order: ``bounce.closest`` (the closest walk with the hit record and
    surface gathers), ``bounce.shade`` (the hit's bookkeeping, samples and
    the material sample), ``bounce.nee`` (the light pick, the shadow walk
    and ``shade()``), ``bounce.shade`` again (weights, carry updates, the
    next ray); without NEE, closest and the two shade spans back to back.
    Counters: ``bounce.lanes[b]`` (lanes handed to the closest walk),
    ``bounce.live[b]`` (those with ``active``, the walk's max_t > 0),
    ``bounce.shadow[b]`` (lanes firing a shadow ray)."""
    batch = ray.batch_shape
    dev = ray.dir.device
    amb3 = torch.as_tensor(amb3, dtype=torch.float32, device=dev)
    nc = amb3.shape[-1]
    bounce_body = _bounce_body(lights=lights, amb3=amb3, eps=eps, nee=nee,
                               reversed_shadow=reversed_shadow)

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
    return _result(nee, bg_color, active, dst, acc, first_hit, first_t)


def _result(nee: bool, bg_color, active, dst, acc, first_hit,
            first_t) -> ResultRecord:
    """The loop's result from its last carry: the colour with alpha 1
    where bounce 0 hit, else ``bg_color``; the first hit and its t."""
    # paths still alive at loop end terminate to black
    out = acc if nee else torch.where(active[..., None], 0.0, dst)
    if out.shape[-1] != 3:
        # fold the spectrum through the CIE observer for display
        out = to_rgb(out)
    rgba = torch.cat([out, torch.ones_like(out[..., :1])], dim=-1)
    color = torch.where(first_hit[..., None], rgba,
                        torch.as_tensor(bg_color, dtype=torch.float32,
                                        device=rgba.device))
    return ResultRecord(color=color, hit=first_hit, depth=first_t)


def _fused_ok(params: KernelParams) -> bool:
    """Whether ``pathtracing_kernel`` can run the bounce as two hand kernels
    around the LBVH walks (``_fused_body``): the scene is triangles alone
    on a flat ``ops.lbvh.BVH`` (LBVH, SAH or SBVH: what ``bvh_traverse``
    walks), with no textures, RGB colour, no hit filter and point lights
    only.  With autograd off or on: on, each bounce is one ``_FusedBounce``
    node, whose backward recomputes the torch body.  Anything else takes
    the torch body."""
    scene = params.scene
    return (isinstance(scene.bvh, BVH) and scene.mesh is not None
            and scene.spheres is None and scene.planes is None
            and scene.textures is None and params.hit_filter is None
            and scene.materials.cd.shape[-1] == 3
            and all(isinstance(g, PointLights)
                    for g in light_groups(scene.lights)))


def _grad_leaves(obj, path=()):
    """``(path, tensor)`` of every tensor that requires grad in ``obj``'s
    dataclass fields, tuples and lists, depth first; ``path`` is the field
    names and indices that lead to it."""
    if isinstance(obj, torch.Tensor):
        return [(path, obj)] if obj.requires_grad else []
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        items = list(enumerate(obj))
    else:
        return []
    return [leaf for k, v in items for leaf in _grad_leaves(v, path + (k,))]


def _with_leaf(obj, path, value):
    """``obj`` with ``value`` at ``path`` (from ``_grad_leaves``), every
    object on the way copied, the rest shared."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(obj, (tuple, list)):
        seq = list(obj)
        seq[k] = _with_leaf(obj[k], rest, value)
        return type(obj)(seq)
    return dataclasses.replace(
        obj, **{k: _with_leaf(getattr(obj, k), rest, value)})


@dataclasses.dataclass
class _Frame:
    """What every fused bounce of one call reads: the parameters, the
    kernels' scene tables and NEE; under autograd, where the parameters'
    tensors that require grad sit (``_grad_leaves``)."""

    params: KernelParams
    sh: bounce_shade.Shading
    tables: tuple
    nee: bool
    paths: tuple = ()


class _Carry(NamedTuple):
    """``pathtrace_loop``'s carry on flat lanes, as ``_fused_bounce`` takes
    and returns it; ``first_hit`` and ``first_t`` come out of bounce 0
    alone."""

    o: torch.Tensor
    d: torch.Tensor
    max_t: torch.Tensor
    state: torch.Tensor
    active: torch.Tensor
    dst: torch.Tensor
    acc: torch.Tensor
    prev_delta: torch.Tensor
    first_hit: torch.Tensor | None = None
    first_t: torch.Tensor | None = None


def _fused_bounce(fr: _Frame, bounce: int, c: _Carry, tape=None) -> _Carry:
    """One bounce as the closest walk, ``ops/bounce_shade.py::shade_hit``,
    the shadow walk and ``shade_close`` (no shadow walk without NEE or
    lights), on flat lanes: the carry after it.  Spans and counters as
    ``pathtrace_loop``'s: ``bounce.closest`` holds the closest walk,
    ``bounce.shade`` the hit kernel, ``bounce.nee`` the shadow walk,
    ``bounce.shade`` the close kernel; ``bounce.shadow`` counts the hit
    kernel's ``fire``.  ``tape``: a ``TraceTape`` that gets each walk's
    ``(best_t, best_ref)`` in the order, and with the shapes, in which the
    torch body's front ends on these lanes record them
    (ops/traversal.py::_search)."""
    bvh = fr.params.scene.bvh
    o, d, dst, acc = c.o, c.d, c.dst, c.acc
    metrics.count("bounce.lanes", o.shape[0], bounce)
    metrics.count("bounce.live", c.active, bounce)
    with metrics.span("bounce.closest", bounce=bounce):
        walks = [traversal.bvh_traverse(o, d, c.max_t, bvh, "triangle",
                                        fr.tables, "closest")]
    with metrics.span("bounce.shade", bounce=bounce):
        hit = bounce_shade.shade_hit(fr.sh, o, d, walks[0][1], c.state,
                                     c.active, dst, acc, bounce)
    shadow_ref = None
    if fr.nee:
        acc = hit.carry
        with metrics.span("bounce.nee", bounce=bounce):
            if hit.fire is not None:
                metrics.count("bounce.shadow", hit.fire, bounce)
                walks.append(traversal.bvh_traverse(
                    hit.shadow_o, hit.shadow_d, hit.shadow_t, bvh,
                    "triangle", fr.tables, "any"))
                shadow_ref = walks[1][1]
    else:
        dst = hit.carry
    with metrics.span("bounce.shade", bounce=bounce):
        nxt = bounce_shade.shade_close(fr.sh, d, hit, shadow_ref, dst, acc,
                                       c.prev_delta, bounce)
    if tape is not None:
        tape.outs.extend(tuple(w) for w in walks)
    first = (hit.first_hit, hit.first_t) if bounce == 0 else (None, None)
    return _Carry(nxt.o, nxt.d, nxt.max_t, hit.state, nxt.active, nxt.dst,
                  nxt.acc, nxt.prev_delta, *first)


def _ray_grads(params: KernelParams, o_rg: bool, d_rg: bool):
    """Whether the torch body's bounce makes its next ray's origin, its
    next direction and its first t require grad, given whether the
    bounce's ray origin (``o_rg``) and direction (``d_rg``) do and what of
    ``params`` does.  The hit's t follows the ray and the vertices; the
    next direction, the sampled lobe's, the view direction, the shading
    normal (with corner normals, interpolated at the hit) and the Blinn
    exponent; the next origin, the hit point pushed along it by epsilon,
    both.  ``_FusedBounce`` marks its outputs by it, so that the backward
    differentiates what the torch body's does, and checks it against each
    recompute."""
    mesh = params.scene.mesh
    hit = o_rg or d_rg or mesh.vertices.requires_grad
    normal = mesh.normals.requires_grad if mesh.face_normals_binding \
        else hit or mesh.corner_normals.requires_grad
    d_next = d_rg or normal or \
        params.scene.materials.specular_exp.requires_grad
    eps = params.epsilon
    o_next = hit or d_next or (isinstance(eps, torch.Tensor)
                               and eps.requires_grad)
    return o_next, d_next, hit


# _FusedBounce.forward(ctx, fr, bounce, *carry, *leaves): the fields of the
# carry a bounce takes, each one's argument index, and the first leaf's
_IN = _Carry._fields[:8]
_ARG = {f: 2 + i for i, f in enumerate(_IN)}
_LEAF0 = 2 + len(_IN)
# what the backward keeps of the input carry; the fields autograd
# differentiates in and, where ``_ray_grads`` says so for the ray's, out
_SAVED = ("o", "d", "state", "active", "dst", "acc", "prev_delta")
_DIFF_IN = ("o", "d", "dst", "acc")
_RAY_OUT = ("o", "d", "first_t")
# the parameters' tensors (``_grad_leaves`` paths) whose gradients the
# adjoint kernel gives, by its name for them
_ADJOINT_LEAVES = {("scene", "mesh", "vertices"): "vertices",
                   ("scene", "materials", "cd"): "cd"}


def _adjoint_ok(fr: _Frame, dev) -> bool:
    """Whether ``_FusedBounce``'s backward runs as the adjoint kernel: the
    lanes are on the card and every parameter tensor that requires grad
    is one the kernel differentiates (the vertices, ``cd``); the ray and
    the carry it differentiates always.  Anything else (a light's
    tensors, other material fields, normals, a tensor epsilon, or the
    CPU) takes the torch body's recompute."""
    return torch.device(dev).type == "cuda" and \
        all(p in _ADJOINT_LEAVES for p in fr.paths)


class _FusedBounce(torch.autograd.Function):
    """A fused bounce under autograd, one node.  Forward: ``_fused_bounce``
    (four launches), its walks recorded on a ``TraceTape``; it saves the
    bounce's input carry, the parameters' tensors that require grad and
    the tape, as ``pathtrace_loop``'s checkpoint keeps, and marks the
    outputs that the torch body would leave constant (``_ray_grads``).
    Backward: where ``_adjoint_ok`` holds, one launch of the adjoint kernel
    from the saved carry and the tape's refs (``_adjoint``); else the
    torch body's bounce (``_bounce_body``) recomputed on detached copies
    of them with the walks replayed (``_recompute``: no walk launches,
    spans carry ``recompute=True``), and ``torch.autograd.grad`` through
    it."""

    @staticmethod
    def forward(ctx, fr, bounce, *args):
        c, leaves = _Carry(*args[:len(_IN)]), args[len(_IN):]
        tape = traverse.TraceTape()
        out = _fused_bounce(fr, bounce, c, tape)
        need = ctx.needs_input_grad
        ctx.fr, ctx.bounce, ctx.tape = fr, bounce, tape
        ctx.marks = dict(zip(_RAY_OUT, _ray_grads(
            fr.params, need[_ARG["o"]], need[_ARG["d"]])))
        ctx.save_for_backward(*(getattr(c, f) for f in _SAVED), *leaves)
        const = ("max_t", "state", "active", "prev_delta", "first_hit") \
            + tuple(f for f, m in ctx.marks.items() if not m)
        ctx.mark_non_differentiable(*(getattr(out, f) for f in const
                                      if getattr(out, f) is not None))
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        fr, bounce = ctx.fr, ctx.bounce
        if _adjoint_ok(fr, ctx.saved_tensors[0].device):
            return _adjoint(ctx, grads)
        saved = ctx.saved_tensors
        c = dict(zip(_SAVED, saved))
        need = ctx.needs_input_grad
        given = {**{_ARG[f]: c[f] for f in _DIFF_IN},
                 **{_LEAF0 + i: t for i, t in enumerate(saved[len(_SAVED):])}}
        with torch.enable_grad():
            x = {i: t.detach().requires_grad_(need[i])
                 for i, t in given.items()}
            params = fr.params
            for i, path in enumerate(fr.paths):
                params = _with_leaf(params, path, x[_LEAF0 + i])
            body = _bounce_body(
                lights=params.scene.lights,
                amb3=torch.as_tensor(params.ambient_color[:3],
                                     dtype=torch.float32,
                                     device=c["o"].device),
                eps=params.epsilon, nee=fr.nee,
                reversed_shadow=params.trace.shadow_reversed)
            tape, ctx.tape = ctx.tape, None
            with _recompute(tape):
                ray, _, _, dst, acc, _, first_t, _ = body(
                    scene_tracer(params, binned=False), bounce,
                    Ray(ori=x[_ARG["o"]], dir=x[_ARG["d"]]),
                    Sampler(c["state"]), c["active"], x[_ARG["dst"]],
                    x[_ARG["acc"]], None, None, c["prev_delta"])
        ys = {"o": ray.ori, "d": ray.dir, "dst": dst, "acc": acc,
              "first_t": first_t}
        if any(ys[f] is not None and ys[f].requires_grad
               for f, m in ctx.marks.items() if not m):
            raise RuntimeError(
                "_FusedBounce: the torch body differentiates an output the "
                "fused bounce marked constant; _ray_grads must follow "
                "_bounce_body")
        g = _Carry(*grads)
        pairs = [(ys[f], getattr(g, f)) for f in ys
                 if getattr(g, f) is not None and ys[f].requires_grad]
        # what no gradient reaches goes before the backward's graph is
        # walked, as a checkpoint's recompute keeps only what is needed
        del ray, dst, acc, first_t, ys
        wrt = [i for i in given if need[i]]
        got = torch.autograd.grad(
            [y for y, _ in pairs], [x[i] for i in wrt],
            [g for _, g in pairs], allow_unused=True) \
            if pairs else [None] * len(wrt)
        out = [None] * len(need)
        for i, gi in zip(wrt, got):
            out[i] = gi
        return tuple(out)


def _adjoint(ctx, grads):
    """``_FusedBounce``'s backward as the adjoint kernel: the gradients of
    the input carry's ray, dst and acc and of the vertices and ``cd``
    that autograd asks for, from the saved carry and the walks' refs on
    the tape."""
    fr = ctx.fr
    c = dict(zip(_SAVED, ctx.saved_tensors))
    need = ctx.needs_input_grad
    tape, ctx.tape = ctx.tape, None
    shadow_ref = tape.outs[1][1] if len(tape.outs) > 1 else None
    g = _Carry(*grads)
    leaves = {_LEAF0 + i: _ADJOINT_LEAVES[p] for i, p in enumerate(fr.paths)}
    want = {f for f in _DIFF_IN if need[_ARG[f]]} | \
        {name for i, name in leaves.items() if need[i]}
    got = bounce_shade.shade_backward(
        fr.sh, c["o"], c["d"], tape.outs[0][1], c["state"], c["active"],
        c["dst"], c["acc"], c["prev_delta"], shadow_ref, g.o, g.d, g.dst,
        g.acc, g.first_t, ctx.bounce, want)
    out = [None] * len(need)
    for f in _DIFF_IN:
        out[_ARG[f]] = getattr(got, f)
    for i, name in leaves.items():
        out[i] = getattr(got, name)
    return tuple(out)


def _fused_body(params: KernelParams, ray: Ray, sampler: Sampler,
                nee: bool) -> ResultRecord:
    """The bounce loop as ``_fused_bounce`` a bounce, on flat lanes; its
    result is ``pathtrace_loop``'s.  Under autograd each bounce is one
    ``_FusedBounce`` node with every tensor of ``params`` that requires
    grad as an input, so gradients reach them as through the torch
    body."""
    scene = params.scene
    batch = ray.batch_shape
    dev = ray.dir.device
    o = ray.ori.reshape(-1, 3).to(torch.float32).contiguous()
    n = o.shape[0]
    grad = torch.is_grad_enabled()
    found = _grad_leaves(params) if grad else []
    leaves = [t for _, t in found]
    with torch.no_grad():
        fr = _Frame(params=params, sh=bounce_shade.Shading.of(params, nee),
                    tables=traversal.prim_tables("triangle", scene.mesh),
                    nee=nee, paths=tuple(p for p, _ in found))
    c = _Carry(
        o=o, d=ray.dir.reshape(-1, 3).to(torch.float32).contiguous(),
        max_t=torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev),
        state=sampler.state.reshape(-1).contiguous(),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        dst=torch.ones((n, 3), dtype=torch.float32, device=dev),
        acc=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        prev_delta=torch.zeros((n,), dtype=torch.bool, device=dev))
    first_hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    first_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    for bounce in range(params.num_bounces):
        c = _Carry(*_FusedBounce.apply(fr, bounce, *c[:len(_IN)], *leaves)) \
            if grad else _fused_bounce(fr, bounce, c)
        if bounce == 0:
            first_hit, first_t = c.first_hit, c.first_t

    return _result(nee, params.bg_color,
                   *(x.reshape(batch + x.shape[1:]) for x in (
                       c.active, c.dst, c.acc, first_hit, first_t)))


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
        tracer0=tracer0, lights=scene.lights, amb3=amb3,
        bg_color=params.bg_color, eps=params.epsilon, nee=nee,
        reversed_shadow=params.trace.shadow_reversed)


def pathtracing_kernel(params: KernelParams, ray: Ray, sampler: Sampler,
                       nee: bool = False) -> ResultRecord:
    """Path-traced colour, first hit and depth of ``ray``: through
    ``_fused_body`` where ``_fused_ok`` holds, with autograd off or on,
    else the torch body."""
    if _fused_ok(params):
        return _fused_body(params, ray, sampler, nee)
    return _torch_body(params, ray, sampler, nee)
