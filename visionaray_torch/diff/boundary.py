"""Silhouette/boundary gradients for primary visibility by edge sampling
(port of diff/boundary.py).

Autodiff differentiates the render at a fixed hit topology: which
primitive covers which pixel is decided without a gradient, so moving a
silhouette across pixels gives exactly zero gradient.  This module adds
the boundary term of

    d/dθ ∫_pixel f(x; θ) dx
      = ∫_pixel ∂θ f dx  +  ∫_{edges ∩ pixel} (f⁻ − f⁺)(x) (n̂·∂x/∂θ) ds

by screen-space edge sampling (Li et al. 2018, "Differentiable Monte Carlo
Ray Tracing through Edge Sampling").  Per edge sample p(s; θ) with
screen-space edge normal n̂:

    contrib = (len_e / M) · sil_e · Δf · (n̂ · p(s; θ))

where only p(s; θ), the projection of the differentiable vertices, carries
gradient.  Δf = f(p − δn̂) − f(p + δn̂) is traced with full rays on both
sides of the edge, so an occluded edge sees the same surface on both sides
and contributes nothing.  Each function returns a (H, W, 4) image whose
value is exactly zero (``img - img.detach()``) and whose gradient carries
the term, scatter-added into the pixel each sample falls in
(``index_put_(..., accumulate=True)``: on the card its atomics add in a
varying order, so gradients agree run to run within rounding, not bit for
bit).  Adding it to the rendered image gives any loss the term.

Scope: primary visibility (camera silhouettes of triangles and spheres)
and hard point-light shadows, with respect to vertices, sphere centres and
radii, light positions and the camera.

``edge_budget`` draws edges with a ``torch.Generator`` seeded from
(seed ^ 0x9E3779B9, frame_num); the JAX package draws with
``jax.random.categorical``, which no torch generator reproduces, so the
budget path agrees with it in expectation only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from visionaray_torch.core.camera import project
from visionaray_torch.core.types import Ray
from visionaray_torch.core.vecmath import cross, dot, mat4_apply
from visionaray_torch.device import resolve_device, take
from visionaray_torch.ops.sampling import Sampler, as_u32, pcg_hash

_MASK = 0xFFFFFFFF


@dataclass
class EdgeAdjacency:
    """Unique undirected mesh edges with their adjacent faces.

    ``edges``  (E, 2) i32 vertex ids (lo, hi)
    ``faces``  (E, 2) i32 adjacent face ids; faces[e, 1] == -1 for a mesh
               boundary edge (one adjacent face).
    """

    edges: Any
    faces: Any


def build_edge_adjacency(faces, vertices=None, weld_decimals: int = 5,
                         device="cuda") -> EdgeAdjacency:
    """Adjacency of a topology, built on the host with numpy.

    ``vertices`` welds coincident positions before pairing edges, which
    soup-style meshes need (each Cornell quad carries its own corners:
    unwelded, every geometric edge would count twice as two open edges).
    Edge endpoint ids keep referencing the original vertices; only the
    pairing uses the welded ids.
    """
    faces = np.asarray(faces)
    canon = None
    if vertices is not None:
        v = np.round(np.asarray(vertices, np.float64), weld_decimals)
        canon = np.unique(v, axis=0, return_inverse=True)[1].reshape(-1)
    eid = {}
    adj = []
    edges = []
    for f in range(faces.shape[0]):
        a, b, c = (int(x) for x in faces[f])
        for u, v in ((a, b), (b, c), (c, a)):
            cu = int(canon[u]) if canon is not None else u
            cv = int(canon[v]) if canon is not None else v
            key = (cu, cv) if cu < cv else (cv, cu)
            if key not in eid:
                eid[key] = len(edges)
                edges.append((u, v) if cu < cv else (v, u))
                adj.append([f, -1])
            else:
                adj[eid[key]][1] = f
    dev = resolve_device(device)
    return EdgeAdjacency(
        edges=torch.as_tensor(np.asarray(edges, np.int32).reshape(-1, 2),
                              device=dev),
        faces=torch.as_tensor(np.asarray(adj, np.int32).reshape(-1, 2),
                              device=dev))


def _generator_seed(seed, frame_num) -> int:
    """A 64-bit seed from (seed ^ 0x9E3779B9, frame_num), mixed so that its
    low 32 bits, all the CPU generator keeps, depend on both."""
    x = (((int(seed) ^ 0x9E3779B9) & _MASK) << 32) | (int(frame_num) & _MASK)
    x = (x * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 32)


def _norm(x, keepdim=False):
    return torch.linalg.norm(x, dim=-1, keepdim=keepdim)


def silhouette_mask(vertices, faces, adjacency: EdgeAdjacency, eye,
                    geom_ids=None, crease_cos: float = 1.0 - 1e-4):
    """(E,) bool: the edge can carry a radiance discontinuity seen from
    ``eye``: mesh-boundary edges, edges whose two faces face the eye
    differently, creases (face normals agree below ``crease_cos``) and
    material seams (``geom_ids`` differ).  Face normals come from the
    current ``vertices``."""
    v1 = take(vertices, faces[:, 0])
    n = cross(take(vertices, faces[:, 1]) - v1,
              take(vertices, faces[:, 2]) - v1)
    nn = n / torch.clamp_min(_norm(n, keepdim=True), 1e-12)
    facing = dot(n, eye - v1) > 0.0
    f0 = adjacency.faces[:, 0]
    f1 = adjacency.faces[:, 1]
    f1c = torch.clamp_min(f1, 0)
    open_edge = f1 < 0
    sil = take(facing, f0) != take(facing, f1c)
    crease = dot(take(nn, f0), take(nn, f1c)) < crease_cos
    mask = open_edge | sil | crease
    if geom_ids is not None:
        mask = mask | (take(geom_ids, f0) != take(geom_ids, f1c))
    return mask


def _cam_frame(cam):
    """(view, proj, eye, z_near) of a Pinhole or a MatrixCamera.  For a
    MatrixCamera the eye is the inverse view translation -R^T t and the
    near plane of a GL projection m23 / (m22 - 1); both differentiable."""
    if hasattr(cam, "view_matrix"):
        return cam.view_matrix(), cam.proj_matrix(), cam.eye, cam.z_near
    view, proj = cam.view, cam.proj
    eye = -(view[0, :3] * view[0, 3] + view[1, :3] * view[1, 3]
            + view[2, :3] * view[2, 3])
    return view, proj, eye, proj[2, 3] / (proj[2, 2] - 1.0)


def _radiance_at(params, cam, sx, sy, width, height, algo, nee, seed,
                 frame_num):
    """Kernel radiance (N, 4) of full rays through continuous window
    coordinates (sx, sy) in [0, W] x [0, H]; no gradient (Δf is a
    coefficient of the boundary term, not a gradient path)."""
    from visionaray_torch.sched.render import KERNELS
    kernel = KERNELS[algo]
    with torch.no_grad():
        # primary_rays adds the +0.5 pixel-centre offset; window
        # coordinates already live on the [0, W] continuum
        ray = cam.primary_rays(sx.detach() - 0.5, sy.detach() - 0.5, width,
                               height)
        n = sx.shape[0]
        pid = pcg_hash(torch.arange(n, dtype=torch.int64, device=sx.device)
                       ^ (int(seed) & _MASK))
        samp = Sampler.seed(0, pid, as_u32(frame_num, sx.device))
        if algo == "pathtracing":
            rec = kernel(params, ray, samp, nee=nee)
        else:
            rec = kernel(params, ray, samp)
    return rec.color


def _probes(params, cam, pts, normal, delta, width, height, algo, nee,
            seed, frame_num):
    """Δf = f(p − δn̂) − f(p + δn̂) at points ``pts`` (..., 2)."""
    shape = pts.shape[:-1]
    probe = delta * normal

    def f(q):
        q = q.reshape(-1, 2)
        return _radiance_at(params, cam, q[:, 0], q[:, 1], width, height,
                            algo, nee, seed, frame_num)

    return (f(pts - probe) - f(pts + probe)).reshape(shape + (4,))


def _splat(pts_d, contrib, width, height):
    """Scatter-add ``contrib`` (..., 4) into the pixel each point falls in
    (box filter, unit pixel); the zero-valued image whose gradient is the
    term."""
    ix = torch.clamp(torch.floor(pts_d[..., 0]).to(torch.int64), 0,
                     width - 1)
    iy = torch.clamp(torch.floor(pts_d[..., 1]).to(torch.int64), 0,
                     height - 1)
    img = torch.zeros((height, width, 4), dtype=torch.float32,
                      device=contrib.device)
    img = img.index_put((iy.reshape(-1), ix.reshape(-1)),
                        contrib.reshape(-1, 4), accumulate=True)
    return img - img.detach()


def _on_screen(p, width, height):
    return ((p[..., 0] >= 0) & (p[..., 0] < width)
            & (p[..., 1] >= 0) & (p[..., 1] < height))


def _edge_normal(tan):
    """Unit screen-space normal of tangents ``tan`` (..., 2)."""
    t = tan / torch.clamp_min(_norm(tan, keepdim=True), 1e-12)
    return torch.stack([-t[..., 1], t[..., 0]], dim=-1)


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def boundary_image(params, cam, width: int, height: int,
                   adjacency: EdgeAdjacency, *, algo: str = "simple",
                   nee: bool = False, samples_per_edge: int = 4,
                   delta: float = 0.03, edge_budget: Optional[int] = None,
                   seed: int = 0, frame_num: int = 1, vertices=None):
    """Zero-valued (H, W, 4) image whose gradient is the primary-visibility
    boundary term of the mesh edges.  Add it to the rendered image before
    the loss.

    ``vertices``: the differentiable vertex tensor, by default
    ``params.scene.mesh.vertices``.  ``delta``: the two-sided probe offset
    in pixels.  ``edge_budget``: if set and below E, that many edges drawn
    per call with replacement, in proportion to silhouette × screen
    length, and reweighted, so the cost does not grow with the mesh.
    """
    mesh = params.scene.mesh
    if vertices is None:
        vertices = mesh.vertices
    view, proj, cam_eye, cam_znear = _cam_frame(cam)

    # differentiable endpoint projection
    win = project(vertices, view, proj, (0.0, 0.0, width, height))[..., :2]
    pa = take(win, adjacency.edges[:, 0])     # (E, 2), carries d/dθ
    pb = take(win, adjacency.edges[:, 1])

    # the estimator's detached geometry
    seg = (pb - pa).detach()
    seg_len = _norm(seg)
    normal = _edge_normal(seg)
    with torch.no_grad():
        sil = silhouette_mask(vertices.detach(), mesh.faces, adjacency,
                              cam_eye.detach(), geom_ids=mesh.geom_ids)
        # near-plane cull: an edge with an endpoint behind the eye
        # projects nonsensically, drop it
        vh = torch.cat([vertices, torch.ones_like(vertices[..., :1])],
                       dim=-1)
        in_front = mat4_apply(view, vh)[..., 2] < -cam_znear
        valid = (sil & take(in_front, adjacency.edges[:, 0])
                 & take(in_front, adjacency.edges[:, 1]) & (seg_len > 1e-6))
    weight = torch.where(valid, seg_len, 0.0)   # per-edge total measure

    if edge_budget is not None and edge_budget < weight.shape[0]:
        # the frame is folded into the seed: a fixed seed across a training
        # loop must not draw the same subset every step
        gen = torch.Generator(device=weight.device)
        gen.manual_seed(_generator_seed(seed, frame_num))
        total = weight.sum()
        p = weight / torch.clamp_min(total, 1e-12)
        idx = torch.multinomial(torch.clamp_min(p, 1e-30), edge_budget,
                                replacement=True, generator=gen)
        # importance weight: sum_e w_e g_e = E_{idx~p}[w_idx g_idx / p_idx]
        ew = torch.where(total > 0, total / edge_budget, 0.0)
        pa, pb, normal = pa[idx], pb[idx], normal[idx]
        edge_w = ew.expand(edge_budget) * (weight[idx] > 0)
    else:
        edge_w = weight

    M = samples_per_edge
    s = ((torch.arange(M, dtype=torch.float32, device=win.device) + 0.5)
         / M)[None, :, None]                                    # stratified
    pt = pa[:, None, :] * (1.0 - s) + pb[:, None, :] * s        # (E, M, 2)
    pt_d = pt.detach()
    nrm = normal[:, None, :]
    dF = _probes(params, cam, pt_d, nrm, delta, width, height, algo, nee,
                 seed, frame_num)
    # the normal velocity of the edge point, the only gradient path
    contrib = (edge_w / M)[:, None, None] * dF * _dot2(nrm, pt)[..., None]
    contrib = torch.where(_on_screen(pt_d, width, height)[..., None],
                          contrib, 0.0)
    return _splat(pt_d, contrib, width, height)


# Secondary visibility: hard-shadow boundaries of point lights.  A shadow
# boundary on a receiver is the projection, through the light, of the
# blocker's light silhouette onto the receiver.  With the curve
# parameterized differentiably -- s on a blocker edge gives q(s; θ); the
# ray L -> q finds the receiver (detached search); the ray meets the
# receiver's plane at r(s; θ); project(r) = p(s; θ) -- the same estimator
# applies, with gradients through the blocker vertices, the light
# position, the receiver vertices and the camera.


def shadow_boundary_image(params, cam, width: int, height: int,
                          adjacency: EdgeAdjacency, *, algo: str = "whitted",
                          nee: bool = False, samples_per_edge: int = 8,
                          delta: float = 0.03, seed: int = 0,
                          frame_num: int = 1, vertices=None,
                          light_pos=None, light_index=0):
    """Zero-valued (H, W, 4) image whose gradient is the hard-shadow
    boundary term of one point light (``light_index``), or the sum over
    every point light (``light_index=None``).  ``light_pos``: a
    differentiable (3,) position overriding the selected light."""
    if light_index is None and light_pos is None:
        img = torch.zeros((height, width, 4), dtype=torch.float32,
                          device=params.scene.device)
        for li in range(int(params.scene.lights.position.shape[0])):
            img = img + shadow_boundary_image(
                params, cam, width, height, adjacency, algo=algo, nee=nee,
                samples_per_edge=samples_per_edge, delta=delta, seed=seed,
                frame_num=frame_num, vertices=vertices, light_index=li)
        return img
    from visionaray_torch.ops.trace import closest_hit

    mesh = params.scene.mesh
    if vertices is None:
        vertices = mesh.vertices
    if light_pos is None:
        light_pos = params.scene.lights.position[light_index]
    L = torch.as_tensor(light_pos, dtype=torch.float32,
                        device=vertices.device)
    view, proj, _, _ = _cam_frame(cam)
    eps = params.epsilon

    with torch.no_grad():
        sil = silhouette_mask(vertices.detach(), mesh.faces, adjacency,
                              L.detach(), geom_ids=mesh.geom_ids)
    E = adjacency.edges.shape[0]
    M = samples_per_edge
    a3 = take(vertices, adjacency.edges[:, 0])     # (E, 3) differentiable
    b3 = take(vertices, adjacency.edges[:, 1])
    s = ((torch.arange(M, dtype=torch.float32, device=a3.device) + 0.5)
         / M)[None, :, None]
    q = a3[:, None, :] * (1.0 - s) + b3[:, None, :] * s     # (E, M, 3)

    # receiver search (detached): closest hit just past the edge point
    with torch.no_grad():
        to_q = q - L[None, None, :]
        dist_q = _norm(to_q)
        dhat = to_q / torch.clamp_min(dist_q, 1e-12)[..., None]
        rhr = closest_hit(Ray(ori=(q + dhat * (4.0 * eps)).reshape(-1, 3),
                              dir=dhat.reshape(-1, 3)), params.scene,
                          trace=params.trace)
        # a sphere or plane winner has a prim id past the faces: clamp it
        # to the last face, as the reference's gather clamps
        rprim = torch.clamp(rhr.prim_id, 0, mesh.faces.shape[0] - 1)
        rvalid = rhr.hit.reshape(E, M)

    # differentiable curve point: ray (L -> q) meets the receiver's plane,
    # taken from the ``vertices`` argument so receiver gradients flow
    fv = take(mesh.faces, rprim)
    rv1 = take(vertices, fv[:, 0])
    pv1 = rv1.reshape(E, M, 3)
    nr = cross(take(vertices, fv[:, 1]) - rv1,
               take(vertices, fv[:, 2]) - rv1).reshape(E, M, 3)

    def curve_point(qq):
        # the unnormalized ray L + t (q - L): t = 1 at the edge point, so
        # a receiver beyond the blocker has t_r > 1
        d = qq - L[None, None, :]
        denom = dot(d, nr)
        scale = _norm(d) * _norm(nr)
        grazing = torch.abs(denom) < 1e-7 * torch.clamp_min(scale, 1e-12)
        t_r = dot(pv1 - L[None, None, :], nr) / torch.where(grazing, 1.0,
                                                           denom)
        r = L[None, None, :] + d * t_r[..., None]
        return project(r, view, proj, (0.0, 0.0, width, height))[..., :2], \
            t_r, grazing

    p, t_r, grazing = curve_point(q)

    # detached tangent, normal and length element from samples s ± ds
    with torch.no_grad():
        ds = 0.5 / M
        edge_dir = (b3 - a3)[:, None, :]
        tan = curve_point(q + edge_dir * ds)[0] - \
            curve_point(q - edge_dir * ds)[0]             # ∝ dp/ds
        normal = _edge_normal(tan)
        # |dp/ds| / M: the curve length each sample carries
        w = _norm(tan) / (2.0 * ds) / M
        p_d = p.detach()
        valid = (sil[:, None] & rvalid & ~grazing
                 & (t_r > 1.0 + 2.0 * eps / torch.clamp_min(dist_q, 1e-6))
                 & _on_screen(p_d, width, height))
        w = torch.where(valid, w, 0.0)

    dF = _probes(params, cam, p_d, normal, delta, width, height, algo, nee,
                 seed, frame_num)
    contrib = w[..., None] * dF * _dot2(normal, p)[..., None]
    return _splat(p_d, contrib, width, height)


# Sphere silhouettes: the boundary curve of a sphere is the circle where
# view rays graze it, closed-form differentiable in (centre C, radius R,
# eye E):  w = (C − E)/d, d = |C − E|; circle centre Q = C − (R²/d) w and
# radius ρ = R sqrt(1 − R²/d²) in the plane ⊥ w.


def sphere_boundary_image(params, cam, width: int, height: int, *,
                          algo: str = "simple", nee: bool = False,
                          samples_per_sphere: int = 32,
                          delta: float = 0.03, seed: int = 0,
                          frame_num: int = 1, centers=None, radii=None):
    """Zero-valued (H, W, 4) image whose gradient is the primary-
    visibility boundary term of the scene's spheres (centres, radii and
    the camera).  ``centers``/``radii``: differentiable overrides of
    ``params.scene.spheres``."""
    sph = params.scene.spheres
    if centers is None:
        centers = sph.center
    if radii is None:
        radii = sph.radius
    view, proj, cam_eye, cam_znear = _cam_frame(cam)
    eye = torch.as_tensor(cam_eye, dtype=torch.float32,
                          device=centers.device)

    S = centers.shape[0]
    M = samples_per_sphere
    to_c = centers - eye[None, :]
    d = _norm(to_c)                                           # (S,)
    visible = d.detach() > radii.detach() * (1.0 + 1e-6)
    w = to_c / torch.clamp_min(d, 1e-12)[..., None]
    # a frame ⊥ w; the helper axis (the smallest |w| component) is chosen
    # without gradient, so the frame never degenerates
    helper_ix = torch.argmin(torch.abs(w.detach()), dim=-1)
    helper = torch.eye(3, dtype=torch.float32, device=w.device)[helper_ix]
    u = cross(w, helper)
    u = u / torch.clamp_min(_norm(u, keepdim=True), 1e-12)
    v = cross(w, u)

    ratio = torch.clamp(radii / torch.clamp_min(d, 1e-12), 0.0, 1.0 - 1e-7)
    Q = centers - (radii * ratio)[..., None] * w              # (S, 3)
    rho = radii * torch.sqrt(1.0 - ratio * ratio)
    phi = ((torch.arange(M, dtype=torch.float32, device=w.device) + 0.5)
           / M * (2.0 * np.pi))

    def circle_screen(phis):
        P = (Q[:, None, :]
             + rho[:, None, None] * (torch.cos(phis)[None, :, None]
                                     * u[:, None, :]
                                     + torch.sin(phis)[None, :, None]
                                     * v[:, None, :]))       # (S, M, 3)
        p = project(P, view, proj, (0.0, 0.0, width, height))[..., :2]
        zv = mat4_apply(view, torch.cat([P, torch.ones_like(P[..., :1])],
                                        dim=-1))[..., 2]
        return p, zv

    p, zv = circle_screen(phi)
    with torch.no_grad():
        dphi = 0.5 * (2.0 * np.pi) / M
        tan = circle_screen(phi + dphi)[0] - circle_screen(phi - dphi)[0]
        normal = _edge_normal(tan)
        wgt = _norm(tan) / (2.0 * dphi) * (2.0 * np.pi / M)   # |dp/dφ| Δφ
        p_d = p.detach()
        valid = (visible[:, None] & (zv < -cam_znear)
                 & _on_screen(p_d, width, height))
        wgt = torch.where(valid, wgt, 0.0)

    # the two-offset sqrt-extrapolated jump: on a curved silhouette the
    # interior radiance meets the limb with a sqrt profile, so one finite
    # probe carries an O(sqrt(delta)) bias; with f(d) = f0 + c sqrt(d),
    # f0 = (sqrt(2) f(d) - f(2d)) / (sqrt(2) - 1)
    def jump(dd):
        return _probes(params, cam, p_d, normal, dd, width, height, algo,
                       nee, seed, frame_num)

    r2 = np.float32(np.sqrt(2.0))
    dF = (float(r2) * jump(delta) - jump(2.0 * delta)) / float(r2 - 1.0)
    contrib = wgt[..., None] * dF * _dot2(normal, p)[..., None]
    return _splat(p_d, contrib, width, height)
