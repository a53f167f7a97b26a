"""The shading of one path-tracing bounce around its two LBVH walks, as two
hand-written CUDA kernels (ops/cuda/bounce_shade.cu), their plain PyTorch
versions, and their adjoint kernel.

``kernels/pathtracing.py::_fused_body`` runs a bounce as four launches:
the closest walk, ``shade_hit``, the shadow walk and ``shade_close``.
Between the walks sit the torch body's operations (shading/bounce.py,
~680 kernels a bounce on the card):

- ``shade_hit`` takes the closest walk's ``best_ref`` and does the hit
  record (``ops/trace.py::closest_hit``), ``get_surface``, ``at_hit``
  (the ambient term of the lanes that exit, the sampler's draws,
  ``Materials.sample``) and, with NEE, ``light_sample``: the light pick,
  the shadow ray (flat, as ``ops/traversal.py::bvh_traverse`` takes it)
  and ``fire``; and the first hit;
- ``shade_close`` takes the shadow walk's ``best_ref`` (visible: fire and
  ref < 0, the walk's contract) and does ``direct_light`` (``shade()``)
  and ``next_ray``: the acc / dst updates, the BRDF weight, ``active``,
  ``prev_delta`` and the next closest ray (flat, max_t = FLT_MAX where
  active, else -1).

What the second needs of the first travels in ``mid``, an (MID, n) f32
buffer (rows below; the flags and the material row as int32 bits).

On CUDA tensors each wrapper launches its kernel and adds one to
``ops/traverse.py::ENTRY_LAUNCHES[entry]``; on CPU tensors it runs its
plain version and adds one to ``PLAIN_CALLS[entry]``.  The plain versions
call the torch body's own pieces on either side of ``mid``, so they equal
the body bit for bit on either device; the kernels follow the card's
rounding of those operations (the .cu file's note).

Under autograd ``shade_backward`` launches ``vsnray_bounce_shade_bwd``:
from the gradients of a bounce's outputs, those of its ray, its dst and
acc, the vertices and the albedo ``cd``, the lane's forward run again in
the kernel (kernels/pathtracing.py::_FusedBounce.backward takes it on CUDA
tensors when those are all the gradients asked for).  Its plain version
is the torch body's recompute under autograd, which is also the CPU path.

Scenes: triangles only, on a flat ``ops.lbvh.BVH`` (LBVH, SAH, SBVH), no
textures, RGB colour, point lights (kernels/pathtracing.py::_fused_ok).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

import visionaray_torch.ops.traverse as trav
from visionaray_torch.core.types import FLT_MAX, Ray
from visionaray_torch.ops import traversal as tt
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import closest_hit
from visionaray_torch.shading import bounce as shade
from visionaray_torch.shading import brdf
from visionaray_torch.shading.lights import light_groups
from visionaray_torch.shading.surface import get_surface

ENTRY_HIT = "vsnray_bounce_shade_hit"
ENTRY_CLOSE = "vsnray_bounce_shade_close"
ENTRY_BWD = "vsnray_bounce_shade_bwd"
# calls of the plain versions (CPU tensors), by the entry point they stand
# for
PLAIN_CALLS = {ENTRY_HIT: 0, ENTRY_CLOSE: 0}

# rows of ``mid``: normal, light direction, light intensity, the sample's
# colour and direction (3 each), its pdf, the hit point (3), flags, the
# material row
MID_N, MID_WL, MID_I, MID_F, MID_WI, MID_PDF, MID_POS = 0, 3, 6, 9, 12, 15, 16
MID_FLAGS, MID_GEOM, MID = 19, 20, 21
HIT, ACTIVE, FIRE, TAKE_D, EMISSIVE, SPECULAR, ZERO_PDF = \
    1, 2, 4, 8, 16, 32, 64
# the flags' bits by the mask of the hit record or the ``Shade`` they hold
BITS = dict(hit=HIT, active=ACTIVE, fire=FIRE, take_d=TAKE_D,
            emissive=EMISSIVE, specular=SPECULAR, zero_pdf=ZERO_PDF)
MAT_COLS = 32      # material table columns (the .cu file's MatCol)
LIGHT_COLS = 10    # position, cl, kl, attenuation


def material_table(mats) -> torch.Tensor:
    """(M, MAT_COLS) f32: the material-only factors of a bounce, each
    computed with the operation the torch body applies to a lane's row
    (shading/brdf.py, shading/materials.py), so each is the value the
    body computes for every lane of that material: mtype (int32 bits),
    lambertian_f, pi * lambertian_f, cs * ks, 1 - cs * ks, exp, exp + 1,
    1 / (exp + 1), (exp + 2) / (8 pi), the plastic lobe's diffuse
    probability, eta^2 + k^2, 2 eta, cr, kr, ce * ls, and kd / pi (the
    factor of cd in lambertian_f, for the adjoint)."""
    f_d = brdf.lambertian_f(mats.cd, mats.kd)
    spec = mats.cs * mats.ks[..., None]
    exp = mats.specular_exp
    prob_diff = torch.mean(mats.cd, dim=-1) * mats.kd
    prob_spec = torch.mean(mats.cs, dim=-1) * mats.ks
    all_zero = (prob_diff == 0.0) & (prob_spec == 0.0)
    prob_diff = torch.where(all_zero, 0.5, prob_diff)
    prob_spec = torch.where(all_zero, 0.5, prob_spec)
    prob_diff = prob_diff / (prob_diff + prob_spec)
    eta, k = mats.ior, mats.absorption
    cols = [mats.mtype.to(torch.int32).view(torch.float32)[:, None], f_d,
            math.pi * f_d, spec, 1.0 - spec, exp[:, None],
            (exp + 1.0)[:, None], (1.0 / (exp + 1.0))[:, None],
            ((exp + 2.0) / (8.0 * math.pi))[:, None], prob_diff[:, None],
            eta * eta + k * k, 2.0 * eta, mats.cr, mats.kr[:, None],
            mats.ce * mats.ls[..., None], (mats.kd * brdf.INV_PI)[:, None]]
    return torch.cat([c.to(torch.float32) for c in cols],
                     dim=1).contiguous()


def light_table(lights) -> torch.Tensor:
    """(L, LIGHT_COLS) f32 of every point light, in the order
    ``shading/bounce.py::light_sample`` numbers them: position, cl, kl,
    attenuation."""
    rows = [torch.cat([g.position, g.cl, g.kl[:, None], g.attenuation],
                      dim=1) for g in light_groups(lights)]
    return torch.cat(rows, dim=0).to(torch.float32).contiguous()


@dataclass
class Shading:
    """What both kernels of a frame read of the scene and parameters."""

    scene: Any
    nee: bool
    reversed: bool        # shadow segments traced from the light end
    total: int            # point lights
    amb: torch.Tensor     # (3,) ambient colour
    eps: torch.Tensor     # () f32
    mat: torch.Tensor     # material_table
    lights: Optional[torch.Tensor]   # light_table, None without lights

    @staticmethod
    def of(params, nee: bool) -> "Shading":
        scene = params.scene
        dev = scene.mesh.vertices.device
        groups = light_groups(scene.lights)
        total = sum(g.num_lights for g in groups)
        amb = torch.as_tensor(params.ambient_color, dtype=torch.float32,
                              device=dev)[:3].contiguous()
        eps = torch.as_tensor(params.epsilon, dtype=torch.float32,
                              device=dev).reshape(())
        mat = tt.kept(scene.materials, "bounce_shade.materials",
                      material_table)
        # the kernel reads a material row by a face's id unchecked: the
        # ids' range, read once a mesh
        lo, hi = tt.kept(scene.mesh, "bounce_shade.geom_range",
                         lambda m: tuple(int(v) for v in
                                         torch.aminmax(m.geom_ids)))
        if lo < 0 or hi >= mat.shape[0]:
            raise ValueError(f"bounce_shade: material ids in [{lo}, {hi}], "
                             f"the table has {mat.shape[0]} rows")
        if total == 0:
            lights = None
        elif len(groups) == 1:
            lights = tt.kept(groups[0], "bounce_shade.lights", light_table)
        else:
            lights = light_table(groups)
        return Shading(scene=scene, nee=nee,
                       reversed=params.trace.shadow_reversed, total=total,
                       amb=amb, eps=eps, mat=mat, lights=lights)


@dataclass
class Hit:
    """``shade_hit``'s outputs: the sampler state, the carry it updates
    (acc with NEE, else dst), the first hit (bounce 0, else None), the
    shadow ray (o, d, max_t) and ``fire`` (NEE with lights, else None) and
    the buffer for ``shade_close``."""

    state: torch.Tensor
    carry: torch.Tensor
    first_hit: Optional[torch.Tensor]
    first_t: Optional[torch.Tensor]
    shadow_o: Optional[torch.Tensor]
    shadow_d: Optional[torch.Tensor]
    shadow_t: Optional[torch.Tensor]
    fire: Optional[torch.Tensor]
    mid: torch.Tensor


@dataclass
class Close:
    """``shade_close``'s outputs: the next closest ray (o, d, max_t) and
    the carry."""

    o: torch.Tensor
    d: torch.Tensor
    max_t: torch.Tensor
    dst: torch.Tensor
    acc: torch.Tensor
    active: torch.Tensor
    prev_delta: torch.Tensor


def _check(entry, dev, n, named):
    for name, x, shape, dtype in named:
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{entry}: {name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{entry}: {name} is on {x.device}, rays on "
                             f"{dev}")
        if not x.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def shade_hit(sh: Shading, o, d, ref, state, active, dst, acc,
              bounce: int) -> Hit:
    """The hit kernel over lanes ``o``, ``d`` (n, 3) with the closest
    walk's ``ref`` (n,) i32, the sampler ``state`` (n,) i64 and the carry
    ``active`` (n,) bool, ``dst``, ``acc`` (n, 3).  CUDA tensors launch
    ``vsnray_bounce_shade_hit``; CPU tensors run ``shade_hit_plain``."""
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(ENTRY_HIT, o.device, n, [
        ("o", o, (n, 3), f32), ("d", d, (n, 3), f32), ("ref", ref, (n,), i32),
        ("state", state, (n,), torch.int64), ("active", active, (n,),
                                              torch.bool),
        ("dst", dst, (n, 3), f32), ("acc", acc, (n, 3), f32)])
    if o.device.type == "cpu":
        PLAIN_CALLS[ENTRY_HIT] += 1
        return shade_hit_plain(sh, o, d, ref, state, active, dst, acc,
                               bounce)
    if o.device.type != "cuda":
        raise ValueError(f"{ENTRY_HIT}: no kernel for {o.device}")
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        out = launch_hit(trav._library(), sh, o, d, ref, state, active, dst,
                         acc, bounce, stream)
    trav.ENTRY_LAUNCHES[ENTRY_HIT] += 1
    return out


def _tables(entry, sh: Shading, dev):
    """The scene's tables a kernel reads, checked: the packed triangle
    records, the BVH's prim ids, face normals, corner normals (None with
    face binding), material ids, and the triangles' count."""
    mesh, bvh = sh.scene.mesh, sh.scene.bvh
    f32, i32 = torch.float32, torch.int32
    nt = mesh.num_prims
    tables = tt.prim_tables("triangle", mesh)
    _, _, prims = tt.kernel_pack(bvh, "triangle", tables)
    corner = None if mesh.face_normals_binding else \
        mesh.corner_normals.to(f32).contiguous()
    normals = mesh.normals.to(f32).contiguous()
    geom_ids = mesh.geom_ids.to(i32).contiguous()
    M = sh.mat.shape[0]
    _check(entry, dev, 0, [
        ("prims", prims, (bvh.num_prims, 3, 4), f32),
        ("prim_ids", bvh.prim_ids, (bvh.num_prims,), i32),
        ("normals", normals, (nt, 3), f32),
        ("corner_normals", corner, (nt, 3, 3), f32),
        ("geom_ids", geom_ids, (nt,), i32),
        ("materials", sh.mat, (M, MAT_COLS), f32),
        ("lights", sh.lights, (sh.total, LIGHT_COLS), f32),
        ("ambient", sh.amb, (3,), f32), ("epsilon", sh.eps, (), f32)])
    return prims, bvh.prim_ids, normals, corner, geom_ids, nt


def launch_hit(lib, sh: Shading, o, d, ref, state, active, dst, acc,
               bounce: int, stream) -> Hit:
    """Check the scene's tables, allocate the outputs and call
    ``lib.vsnray_bounce_shade_hit`` on inputs ``shade_hit`` has checked;
    raises on a launch error."""
    n = o.shape[0]
    f32 = torch.float32
    prims, prim_ids, normals, corner, geom_ids, nt = _tables(ENTRY_HIT, sh,
                                                            o.device)
    dev = o.device

    def new(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    first = bounce == 0
    shadows = sh.nee and sh.total > 0
    out = Hit(state=new(n, dtype=torch.int64), carry=new(n, 3),
              first_hit=new(n, dtype=torch.bool) if first else None,
              first_t=new(n) if first else None,
              shadow_o=new(n, 3) if shadows else None,
              shadow_d=new(n, 3) if shadows else None,
              shadow_t=new(n) if shadows else None,
              fire=new(n, dtype=torch.bool) if shadows else None,
              mid=new(MID, n))
    if n == 0:
        return out
    err = lib.vsnray_bounce_shade_hit(
        o.data_ptr(), d.data_ptr(), ref.data_ptr(), state.data_ptr(),
        active.data_ptr(), dst.data_ptr(), acc.data_ptr(), prims.data_ptr(),
        prim_ids.data_ptr(), normals.data_ptr(), _ptr(corner),
        geom_ids.data_ptr(), sh.mat.data_ptr(), _ptr(sh.lights),
        sh.amb.data_ptr(), sh.eps.data_ptr(), out.state.data_ptr(),
        out.carry.data_ptr(), _ptr(out.first_hit), _ptr(out.first_t),
        _ptr(out.shadow_o), _ptr(out.shadow_d), _ptr(out.shadow_t),
        _ptr(out.fire), out.mid.data_ptr(), n, nt, sh.total, int(sh.nee),
        int(sh.reversed), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_HIT} launch failed: cudaError {err}")
    return out


def shade_close(sh: Shading, d, hit: Hit, shadow_ref, dst, acc,
                prev_delta, bounce: int) -> Close:
    """The close kernel over the lanes of ``shade_hit``'s ``hit``: ``d``
    (n, 3) the closest walk's directions, ``shadow_ref`` (n,) i32 the
    shadow walk's (None without one), the carry ``dst``, ``acc`` (n, 3)
    and ``prev_delta`` (n,) bool.  CUDA tensors launch
    ``vsnray_bounce_shade_close``; CPU tensors run ``shade_close_plain``."""
    n = d.shape[0]
    f32 = torch.float32
    if (shadow_ref is None) != (hit.fire is None):
        raise ValueError(f"{ENTRY_CLOSE}: a shadow walk's refs go with a "
                         f"hit that fired shadow rays")
    _check(ENTRY_CLOSE, d.device, n, [
        ("d", d, (n, 3), f32), ("mid", hit.mid, (MID, n), f32),
        ("shadow_ref", shadow_ref, (n,), torch.int32),
        ("dst", dst, (n, 3), f32), ("acc", acc, (n, 3), f32),
        ("prev_delta", prev_delta, (n,), torch.bool)])
    if d.device.type == "cpu":
        PLAIN_CALLS[ENTRY_CLOSE] += 1
        return shade_close_plain(sh, d, hit, shadow_ref, dst, acc,
                                 prev_delta, bounce)
    if d.device.type != "cuda":
        raise ValueError(f"{ENTRY_CLOSE}: no kernel for {d.device}")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        out = launch_close(trav._library(), sh, d, hit, shadow_ref, dst,
                           acc, prev_delta, bounce, stream)
    trav.ENTRY_LAUNCHES[ENTRY_CLOSE] += 1
    return out


def launch_close(lib, sh: Shading, d, hit: Hit, shadow_ref, dst, acc,
                 prev_delta, bounce: int, stream) -> Close:
    """Allocate the outputs and call ``lib.vsnray_bounce_shade_close`` on
    inputs ``shade_close`` has checked; raises on a launch error."""
    n = d.shape[0]
    dev = d.device

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Close(o=new(n, 3), d=new(n, 3), max_t=new(n), dst=new(n, 3),
                acc=new(n, 3), active=new(n, dtype=torch.bool),
                prev_delta=new(n, dtype=torch.bool))
    if n == 0:
        return out
    err = lib.vsnray_bounce_shade_close(
        d.data_ptr(), hit.mid.data_ptr(), _ptr(shadow_ref), dst.data_ptr(),
        acc.data_ptr(), prev_delta.data_ptr(), sh.mat.data_ptr(),
        sh.eps.data_ptr(), out.o.data_ptr(), out.d.data_ptr(),
        out.max_t.data_ptr(), out.dst.data_ptr(), out.acc.data_ptr(),
        out.active.data_ptr(), out.prev_delta.data_ptr(), n, sh.total,
        int(sh.nee), int(bounce == 0), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_CLOSE} launch failed: cudaError {err}")
    return out


@dataclass
class Grads:
    """``shade_backward``'s outputs, each None where not asked for: the
    gradients of the bounce's ray origin and direction, dst and acc (n,
    3), of the vertices (V, 3) and of the albedo ``cd`` (M, 3)."""

    o: Optional[torch.Tensor]
    d: Optional[torch.Tensor]
    dst: Optional[torch.Tensor]
    acc: Optional[torch.Tensor]
    vertices: Optional[torch.Tensor]
    cd: Optional[torch.Tensor]


def shade_backward(sh: Shading, o, d, ref, state, active, dst, acc,
                   prev_delta, shadow_ref, g_o, g_d, g_dst, g_acc,
                   g_first_t, bounce: int, want) -> Grads:
    """The adjoint of one bounce's ``shade_hit`` and ``shade_close``: its
    inputs (``o``, ``d`` (n, 3), the closest walk's ``ref``, ``state``,
    ``active``, ``dst``, ``acc``, ``prev_delta`` and the shadow walk's
    ``shadow_ref``, None without one) and the gradients of its outputs
    (the next ray's origin and direction, dst and acc (n, 3), the first t
    (n,) at bounce 0), each None where none reaches it.  ``want``: the
    names of ``Grads``' fields to compute.  CUDA tensors launch
    ``vsnray_bounce_shade_bwd``; there is no CPU form (the CPU runs the
    torch body's recompute, the kernel's plain version)."""
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    gs = [None if g is None else g.to(f32).contiguous()
          for g in (g_o, g_d, g_dst, g_acc, g_first_t)]
    _check(ENTRY_BWD, o.device, n, [
        ("o", o, (n, 3), f32), ("d", d, (n, 3), f32), ("ref", ref, (n,), i32),
        ("state", state, (n,), torch.int64),
        ("active", active, (n,), torch.bool), ("dst", dst, (n, 3), f32),
        ("acc", acc, (n, 3), f32),
        ("prev_delta", prev_delta, (n,), torch.bool),
        ("shadow_ref", shadow_ref, (n,), i32),
        *[(f"g_{k}", g, (n, 3), f32)
          for k, g in zip(("o", "d", "dst", "acc"), gs)],
        ("g_first_t", gs[4], (n,), f32)])
    if (shadow_ref is None) != (not sh.nee or sh.total == 0):
        raise ValueError(f"{ENTRY_BWD}: a shadow walk's refs go with NEE "
                         f"and lights")
    if o.device.type != "cuda":
        raise ValueError(f"{ENTRY_BWD}: no kernel for {o.device} (the "
                         f"torch body's recompute is its plain version)")
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        out = launch_bwd(trav._library(), sh, o, d, ref, state, active, dst,
                         acc, prev_delta, shadow_ref, *gs, bounce, want,
                         stream)
    trav.ENTRY_LAUNCHES[ENTRY_BWD] += 1
    return out


def launch_bwd(lib, sh: Shading, o, d, ref, state, active, dst, acc,
               prev_delta, shadow_ref, g_o, g_d, g_dst, g_acc, g_first_t,
               bounce: int, want, stream) -> Grads:
    """Allocate the gradients in ``want`` (those of the vertices and the
    albedo zeroed, in f64 for the kernel's sums) and call
    ``lib.vsnray_bounce_shade_bwd`` on inputs ``shade_backward`` has
    checked; raises on a launch error."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    mesh = sh.scene.mesh
    prims, prim_ids, normals, corner, geom_ids, nt = _tables(ENTRY_BWD, sh,
                                                            dev)
    M = sh.mat.shape[0]
    out = Grads(**{k: torch.empty((n, 3), dtype=f32, device=dev)
                   if k in want else None for k in ("o", "d", "dst", "acc")},
                vertices=torch.zeros(tuple(mesh.vertices.shape),
                                     dtype=torch.float64, device=dev)
                if "vertices" in want else None,
                cd=torch.zeros((M, 3), dtype=torch.float64, device=dev)
                if "cd" in want else None)
    faces = None
    if out.vertices is not None:
        faces = mesh.faces.to(torch.int32).contiguous()
        _check(ENTRY_BWD, dev, n, [("faces", faces, (nt, 3), torch.int32)])
    if n > 0:
        err = lib.vsnray_bounce_shade_bwd(
            o.data_ptr(), d.data_ptr(), ref.data_ptr(), state.data_ptr(),
            active.data_ptr(), dst.data_ptr(), acc.data_ptr(),
            prev_delta.data_ptr(), _ptr(shadow_ref), prims.data_ptr(),
            prim_ids.data_ptr(), normals.data_ptr(), _ptr(corner),
            geom_ids.data_ptr(), _ptr(faces), sh.mat.data_ptr(),
            _ptr(sh.lights), sh.amb.data_ptr(), sh.eps.data_ptr(),
            _ptr(g_o), _ptr(g_d), _ptr(g_dst), _ptr(g_acc), _ptr(g_first_t),
            _ptr(out.o), _ptr(out.d), _ptr(out.dst), _ptr(out.acc),
            _ptr(out.vertices), _ptr(out.cd), n, nt, sh.total, M,
            int(sh.nee), int(bounce == 0), stream)
        if err != 0:
            raise RuntimeError(f"{ENTRY_BWD} launch failed: cudaError {err}")
    for k in ("vertices", "cd"):
        if getattr(out, k) is not None:
            setattr(out, k, getattr(out, k).to(f32))
    return out


# ---------------------------------------------------------------------------
# The plain versions: the torch body's pieces (shading/bounce.py) around
# the walks.


def shade_hit_plain(sh: Shading, o, d, ref, state, active, dst, acc,
                    bounce: int) -> Hit:
    """``shade_hit`` in plain PyTorch: the walk's ``ref`` replayed through
    ``closest_hit`` (a one-entry ``TraceTape``; its closest front end reads
    the ref alone), ``get_surface``, ``shade.at_hit`` and, with NEE,
    ``shade.light_sample``; ``mid`` packs the ``Shade``."""
    scene = sh.scene
    ray = Ray(ori=o, dir=d)
    tape = trav.TraceTape()
    tape.outs.append((None, ref))
    with trav.replaying(tape):
        hit_rec = closest_hit(ray, scene,
                              max_t=torch.where(active, FLT_MAX, -1.0))
    h, dst, acc = shade.at_hit(hit_rec, get_surface(hit_rec, ray, scene),
                               ray, Sampler(state), active, dst, acc,
                               amb=sh.amb, nee=sh.nee)
    shadow = mt = None
    if sh.nee:
        h, shadow, mt = shade.light_sample(scene.lights, h, sh.eps,
                                           reversed_shadow=sh.reversed)
    zeros = torch.zeros_like(h.n)
    masks = dict(h._asdict(), hit=hit_rec.hit)
    flags = sum(masks[f].to(torch.int32) * b for f, b in BITS.items()
                if masks[f] is not None)
    mid = torch.cat([h.n.T, (zeros if h.wi is None else h.wi).T,
                     (zeros if h.I is None else h.I).T, h.src.T,
                     h.refl_dir.T, h.pdf[None], h.pos.T,
                     flags.to(torch.int32).view(torch.float32)[None],
                     hit_rec.geom_id.to(torch.int32).view(
                         torch.float32)[None]], dim=0).contiguous()
    first = bounce == 0
    return Hit(state=h.sampler.state, carry=acc if sh.nee else dst,
               first_hit=hit_rec.hit if first else None,
               first_t=hit_rec.t if first else None,
               shadow_o=None if shadow is None else shadow.ori.contiguous(),
               shadow_d=None if shadow is None else shadow.dir.contiguous(),
               shadow_t=mt, fire=h.fire, mid=mid)


def shade_close_plain(sh: Shading, d, hit: Hit, shadow_ref, dst, acc,
                      prev_delta, bounce: int) -> Close:
    """``shade_close`` in plain PyTorch: ``hit.mid`` unpacked into the
    ``Shade``, ``shade.direct_light`` (NEE) and ``shade.next_ray``."""
    mid = hit.mid

    def rows3(r):
        # (n, 3) in the body's layout: a reduction over the last axis
        # rounds by the layout (on the card, (x0 + x2) + x1 over a
        # contiguous row, in order over a strided one)
        return mid[r:r + 3].T.contiguous()

    flags = mid[MID_FLAGS].view(torch.int32)
    bit = {f: (flags & b) != 0 for f, b in BITS.items() if f != "hit"}
    fire = bit.pop("fire")
    h = shade.Shade(n=rows3(MID_N), view_dir=-d, src=rows3(MID_F),
                    refl_dir=rows3(MID_WI), pdf=mid[MID_PDF],
                    pos=rows3(MID_POS), **bit)
    direct = None
    if sh.nee:
        if shadow_ref is not None:
            h = h._replace(
                mats=sh.scene.materials.take(mid[MID_GEOM].view(torch.int32)),
                wi=rows3(MID_WL), I=rows3(MID_I), g=torch.ones_like(h.pdf),
                fire=fire, total=sh.total)
        direct = shade.direct_light(
            h, None if shadow_ref is None else shadow_ref >= 0)
    ray, active, dst, acc, prev_delta = shade.next_ray(
        h, direct, dst, acc, prev_delta, eps=sh.eps, nee=sh.nee,
        first=bounce == 0)
    return Close(o=ray.ori.contiguous(), d=ray.dir.contiguous(),
                 max_t=torch.where(active, FLT_MAX, -1.0), dst=dst, acc=acc,
                 active=active, prev_delta=prev_delta)
