"""Frame rendering front end (port of sched/render.py: the simple,
Whitted, AO, path-tracing (RGB and spectral) and volume kernels, and the
boundary-gradient term).

Images are (H, W, 4) with row 0 the bottom scanline.  A render runs under
torch.inference_mode() unless autograd is on and a tensor of the scene, the
camera or the kernel parameters requires grad; then it records the graph
that ``sched/step.py`` differentiates.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from visionaray_torch.device import resolve_device
from visionaray_torch.io.pixel_format import TypedRenderTarget, blend_device
from visionaray_torch.kernels.ao import ao_kernel
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.kernels.pathtracing import pathtracing_kernel
from visionaray_torch.kernels.simple import simple_kernel
from visionaray_torch.kernels.volume import volume_kernel
from visionaray_torch.kernels.whitted import whitted_kernel
from visionaray_torch.ops.sampling import Sampler, as_u32, pcg_hash
from visionaray_torch.shading.lights import light_groups
from visionaray_torch.shading.spectrum import lift_scene

KERNELS = {"simple": simple_kernel, "whitted": whitted_kernel,
           "ao": ao_kernel, "pathtracing": pathtracing_kernel,
           "volume": volume_kernel}

SSAA_OFFSETS = {
    1: [(0.0, 0.0)],
    2: [(-0.25, -0.25), (0.25, 0.25)],
    4: [(-0.125, -0.375), (0.375, -0.125), (0.125, 0.375), (-0.375, 0.125)],
    8: [(-0.4375, 0.0625), (-0.3125, -0.1875), (-0.1875, 0.3125),
        (-0.0625, -0.4375), (0.0625, 0.4375), (0.1875, -0.3125),
        (0.3125, 0.1875), (0.4375, -0.0625)],
}


def _ssaa_offsets(spp: int):
    """Reference tables for 1/2/4/8 samples; an (i/N, radical-inverse-2)
    lattice otherwise."""
    if spp in SSAA_OFFSETS:
        return SSAA_OFFSETS[spp]

    def rad2(i: int) -> float:
        x, f = 0.0, 0.5
        while i:
            x += f * (i & 1)
            i >>= 1
            f *= 0.5
        return x

    return [((i + 0.5) / spp - 0.5, rad2(i) - 0.5) for i in range(spp)]


@dataclass
class RenderTarget:
    """Color + depth frame buffer."""

    color: Any   # (H, W, 4) f32 linear RGBA
    depth: Any   # (H, W) f32
    width: int
    height: int

    @staticmethod
    def create(width: int, height: int, device="cuda") -> "RenderTarget":
        """A cleared frame buffer on ``device``."""
        dev = resolve_device(device)
        return RenderTarget(
            color=torch.zeros((height, width, 4), dtype=torch.float32,
                              device=dev),
            depth=torch.zeros((height, width), dtype=torch.float32,
                              device=dev),
            width=width, height=height)


@dataclass(frozen=True)
class SchedParams:
    """The scheduler's parameters (make_sched_params, scheduler.h)."""

    algo: str = "simple"
    spp: int = 1
    pixel_sampler: str = "uniform"   # uniform | ssaa | jittered |
    #                                  jittered_blend
    tile_size: int = 0               # 0 = the whole frame at once


def _pixel_grid(width, height, device):
    x = torch.arange(width, dtype=torch.int32, device=device)
    y = torch.arange(height, dtype=torch.int32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")   # (H, W)
    return xx.reshape(-1), yy.reshape(-1)


def _grad_scope(scene, cam, params=None):
    """inference_mode(), or no change when a gradient is wanted: autograd
    is on and some input tensor requires grad."""
    objs = [scene.mesh, scene.spheres, scene.planes, scene.materials,
            scene.textures, scene.volumes, cam, params,
            *light_groups(scene.lights)]
    wanted = torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for o in objs if dataclasses.is_dataclass(o)
        for v in vars(o).values())
    return contextlib.nullcontext() if wanted else torch.inference_mode()


def _check_algo(algo: str):
    if algo not in KERNELS:
        raise ValueError(f"algo={algo!r}: the kernels are "
                         f"{', '.join(KERNELS)}")


def algo_defaults(algo: str):
    """(bounces, ambient, pixel sampler) that ``render`` picks for ``algo``
    when the caller gives none (the reference's viewer defaults): 10
    bounces and ambient 1 for path tracing, else 4 and 0; the progressive
    jittered_blend sampler for path tracing and AO, else uniform."""
    pt = algo == "pathtracing"
    return (10 if pt else 4,
            (1.0, 1.0, 1.0, 1.0) if pt else (0.0, 0.0, 0.0, 0.0),
            "jittered_blend" if algo in ("pathtracing", "ao") else "uniform")


def render_pixels(params: KernelParams, cam, x, y, width, height,
                  algo: str, spp: int, pixel_sampler: str,
                  frame_num, seed: int = 0, nee: bool = False):
    """Render a flat batch of pixels; returns (color (N, 4), depth (N,))."""
    _check_algo(algo)
    kernel = KERNELS[algo]
    with _grad_scope(params.scene, cam, params):
        pixel_id = (as_u32(y) * (width & 0xFFFFFFFF) + as_u32(x)) & 0xFFFFFFFF
        ssaa = torch.tensor(_ssaa_offsets(spp), dtype=torch.float32,
                            device=x.device)
        color = torch.zeros(tuple(x.shape) + (4,), dtype=torch.float32,
                            device=x.device)
        depth = torch.zeros(tuple(x.shape), dtype=torch.float32,
                            device=x.device)
        for s in range(spp):
            stream = pcg_hash((seed + s * 0x85EBCA6B) & 0xFFFFFFFF)
            samp = Sampler.seed(0, pixel_id ^ stream.to(x.device),
                                as_u32(frame_num, x.device))
            if pixel_sampler in ("jittered", "jittered_blend"):
                (jx, jy), samp = samp.next_n(2)
                jitter = torch.stack([jx - 0.5, jy - 0.5], dim=-1)
            elif pixel_sampler == "ssaa":
                jitter = ssaa[s].expand(tuple(x.shape) + (2,))
            else:
                jitter = None
            ray = cam.primary_rays(x, y, width, height, jitter)
            if algo == "pathtracing":
                rec = kernel(params, ray, samp, nee=nee)
            else:
                rec = kernel(params, ray, samp)
            color = color + rec.color
            depth = depth + torch.where(rec.hit, rec.depth, 0.0)
        return color / spp, depth / spp


def _render_frame(params: KernelParams, cam, width: int, height: int,
                  algo: str, spp: int, pixel_sampler: str, tile_size: int,
                  frame_num, seed: int = 0, nee: bool = False):
    x, y = _pixel_grid(width, height, params.scene.device)
    n = x.shape[0]
    if tile_size and n > tile_size:
        parts = [render_pixels(params, cam, x[i:i + tile_size],
                               y[i:i + tile_size], width, height, algo, spp,
                               pixel_sampler, frame_num, seed, nee=nee)
                 for i in range(0, n, tile_size)]
        color = torch.cat([p[0] for p in parts])
        depth = torch.cat([p[1] for p in parts])
    else:
        color, depth = render_pixels(params, cam, x, y, width, height, algo,
                                     spp, pixel_sampler, frame_num, seed,
                                     nee=nee)
    return color.reshape(height, width, 4), depth.reshape(height, width)


def render(scene, cam, width: int, height: int, algo: str = "simple",
           spp: int = 1, bounces: Optional[int] = None,
           epsilon: Optional[float] = None, bg_color=(0.1, 0.4, 1.0, 1.0),
           ambient: Optional[tuple] = None, pixel_sampler: Optional[str] = None,
           frame_num: int = 1, seed: int = 0, tile_size: int = 0,
           rt: Optional[RenderTarget] = None, nee: bool = False,
           spectral: int = 0, hit_filter=None, boundary=None,
           boundary_opts: Optional[dict] = None):
    """Render one frame on the scene's device; returns a RenderTarget
    (pass ``rt`` for the progressive blend, alpha = 1/frame_num).

    Defaults as in the JAX package: the simple kernel; bounces, ambient
    and pixel sampler by algorithm (``algo_defaults``); epsilon =
    max(1e-3, 1e-5 * scene diagonal).

    ``hit_filter``: the custom-intersector hook ``fn(prim_id, t, u, v,
    hit) -> hit`` of every closest/any-hit query of the kernel.
    ``boundary``: True (adjacency built here, on the host) or an
    ``EdgeAdjacency`` adds the zero-valued image whose gradient is the
    primary-visibility boundary term of the mesh edges (and, with spheres
    in the scene, of their silhouettes); ``boundary_opts`` are passed to
    ``diff/boundary.py::boundary_image``.
    ``spectral`` = N > 0 (pathtracing only): the scene lifted to N-sample
    SPDs (``shading/spectrum.py::lift_scene``) and path traced per
    wavelength; scenes whose materials already carry SPD channels
    (``cornell_box_spectral``) run spectrally without it.
    ``algo="volume"`` marches ``scene.volumes`` (kernels/volume.py).
    ``rt``: a RenderTarget, or a quantized ``io.pixel_format.
    TypedRenderTarget`` that the frame is blended into on the device.
    """
    _check_algo(algo)
    if spectral:
        if algo != "pathtracing":
            raise ValueError("spectral mode is a pathtracing mode")
        scene = lift_scene(scene, spectral)
    if rt is not None and not isinstance(rt, (RenderTarget,
                                              TypedRenderTarget)):
        raise NotImplementedError(
            f"render: rt must be a RenderTarget or a TypedRenderTarget, "
            f"got {type(rt).__name__}")
    d_bounces, d_ambient, d_sampler = algo_defaults(algo)
    bounces = d_bounces if bounces is None else bounces
    ambient = d_ambient if ambient is None else ambient
    pixel_sampler = d_sampler if pixel_sampler is None else pixel_sampler
    with _grad_scope(scene, cam):
        if epsilon is None:
            bbox = scene.bbox()
            diag = float(torch.linalg.norm(bbox.hi - bbox.lo).detach())
            epsilon = max(1e-3, diag * 1e-5)
        params = KernelParams.create(
            scene, num_bounces=bounces, epsilon=epsilon, bg_color=bg_color,
            ambient_color=ambient, hit_filter=hit_filter)
        color, depth = _render_frame(params, cam, width, height, algo, spp,
                                     pixel_sampler, tile_size, frame_num,
                                     seed, nee=nee)
        if boundary is not None and boundary is not False:
            color = color + _boundary_term(params, cam, width, height, algo,
                                           nee, frame_num, seed, boundary,
                                           boundary_opts)
        if rt is None:
            return RenderTarget(color=color, depth=depth, width=width,
                                height=height)
        # progressive blend, alpha = 1/frame_num (sched_common.h:515-529)
        alpha = 1.0 / torch.tensor(float(frame_num), dtype=torch.float32,
                                   device=color.device)
        if isinstance(rt, TypedRenderTarget):
            # a quantized target: blend through the device pixel_access
            # path (the reference GL targets' blend into unorm8)
            return dataclasses.replace(
                blend_device(rt, color, alpha, 1.0 - alpha),
                depth=rt.depth * (1.0 - alpha) + depth * alpha)
        return dataclasses.replace(
            rt, color=rt.color * (1.0 - alpha) + color * alpha,
            depth=rt.depth * (1.0 - alpha) + depth * alpha)


def _boundary_term(params, cam, width, height, algo, nee, frame_num, seed,
                   boundary, boundary_opts):
    """The zero-valued images of diff/boundary.py whose gradients are the
    boundary terms of the mesh edges and of the sphere silhouettes."""
    from visionaray_torch.diff.boundary import (
        EdgeAdjacency, boundary_image, build_edge_adjacency,
        sphere_boundary_image,
    )
    scene = params.scene
    img = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=scene.device)
    if scene.mesh is not None:
        adj = boundary if isinstance(boundary, EdgeAdjacency) else \
            build_edge_adjacency(scene.mesh.faces.cpu().numpy(),
                                 scene.mesh.vertices.detach().cpu().numpy(),
                                 device=scene.device)
        img = img + boundary_image(params, cam, width, height, adj,
                                   algo=algo, nee=nee, frame_num=frame_num,
                                   seed=seed, **(boundary_opts or {}))
    if scene.spheres is not None:
        img = img + sphere_boundary_image(params, cam, width, height,
                                          algo=algo, nee=nee,
                                          frame_num=frame_num, seed=seed)
    return img
