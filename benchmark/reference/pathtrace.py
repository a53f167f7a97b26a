"""The plain reference: a path tracer with next-event estimation in plain
PyTorch, written from the renderer's published semantics and independent
of the program (it imports nothing of it and takes nothing it made).

What it computes, lane by lane, for a pixel (x, y) of frame f:

- the counter-based sampler: PCG-RXS-M-XS over uint32 lanes held in
  int64, keyed by (pixel id y * width + x, frame); two draws jitter the
  pixel, six more each bounce (lobe, two for the direction, light, two
  for an area light);
- the pinhole camera's ray through the jittered pixel;
- per bounce: the closest hit in (0, inf) over every triangle, the face
  normal turned to the viewer, the one point light's direct term through
  a shadow segment traced from the light end (``dist - 2 eps`` long), and
  the next direction from the material: matte (cosine lobe) or plastic
  (the lobe picked by the mean diffuse against the mean specular colour,
  Blinn half-vector sampling), weighted by cos / pdf;
- rays that leave the scene add the ambient colour times their
  throughput; a path still alive after the last bounce adds nothing;
  a pixel whose camera ray misses takes the background colour.

The search is the reference's own: a complete binary tree of median
splits, four triangles to a leaf (heap order), and a per-lane stack walk
in lockstep.  It only decides
which triangle a lane hits; (t, u, v) at that triangle are evaluated
again with autograd, so the loss is differentiable in the vertices and
the diffuse colours.  ``dtype`` sets the precision of every float.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

MASK = 0xFFFFFFFF
_MUL, _INC, _MIX = 747796405, 2891336453, 277803737
_UNIT = 2.3283064e-10
FLT_MAX = 3.4028234663852886e38
LEAF = 4                       # triangles a leaf
MATTE, PLASTIC = 1, 3          # the material types the configurations use


# ----------------------------------------------------------------- sampler
def _pcg_out(x):
    word = (((x >> ((x >> 28) + 4)) ^ x) * _MIX) & MASK
    return (word >> 22) ^ word


def pcg_hash(x):
    return _pcg_out((x * _MUL + _INC) & MASK)


def sampler_state(pixel_id, frame: int):
    """The sampler of pixel ids (int64 uint32 values) for one frame."""
    stream = pcg_hash(torch.zeros((), dtype=torch.int64,
                                  device=pixel_id.device))
    pid = (pixel_id ^ stream) & MASK
    f = torch.full((), int(frame) & MASK, dtype=torch.int64,
                   device=pixel_id.device)
    return pcg_hash(pcg_hash(pid ^ pcg_hash((f * 0x9E3779B9) & MASK)))


def draws(state, n: int, dtype):
    """n uniforms in [0, 1] and the advanced state."""
    out = []
    for _ in range(n):
        state = (state * _MUL + _INC) & MASK
        u = _pcg_out(state).to(torch.float32) * torch.tensor(
            _UNIT, dtype=torch.float32, device=state.device)
        out.append(u.to(dtype))
    return out, state


# ------------------------------------------------------------- vector math
def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    d = dot(v, v)
    if v.dtype == torch.bfloat16:
        # the control: bfloat16 rounds some vectors to exactly zero (the
        # sum wo + wi of a grazing half-vector sample, the edges of small
        # triangles), which float32 does not; keep those lanes finite
        d = torch.clamp_min(d, torch.finfo(v.dtype).tiny)
    return v * torch.rsqrt(d)[..., None]


def reflect(i, n):
    return 2.0 * dot(n, i)[..., None] * n - i


def basis(w):
    """(u, v) completing w to an orthonormal frame."""
    z = torch.zeros_like(w[..., 0])
    v = torch.where((w[..., 0].abs() > w[..., 1].abs())[..., None],
                    torch.stack([-w[..., 2], z, w[..., 0]], -1),
                    torch.stack([z, w[..., 2], -w[..., 1]], -1))
    v = normalize(v)
    return cross(v, w), v


def triangle(o, d, v1, e1, e2):
    """Moeller-Trumbore: (t, u, v, hit); t = -1 where not hit."""
    s1 = cross(d, e2)
    div = dot(s1, e1)
    hit = div != 0.0
    inv = torch.where(hit, 1.0 / torch.where(hit, div, 1.0), 0.0)
    dd = o - v1
    b1 = dot(dd, s1) * inv
    s2 = cross(dd, e1)
    b2 = dot(d, s2) * inv
    hit = hit & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = torch.where(hit, dot(e2, s2) * inv, -1.0)
    return t, b1, b2, hit


# -------------------------------------------------------------------- tree
@dataclass
class Tree:
    lo: torch.Tensor        # (2P, 3) node boxes, heap order, node 1 the root
    hi: torch.Tensor
    tris: torch.Tensor      # (P, LEAF) triangle ids of each leaf, -1 empty
    leaves: int             # P, a power of two
    depth: int


def build_tree(v1, e1, e2, dtype) -> Tree:
    """A complete binary tree over ``v1, e1, e2`` (F, 3) by median splits:
    level by level, every node's triangles are sorted by their box centres
    along the node's longest axis and halved."""
    with torch.no_grad():
        v1, e1, e2 = (x.detach().float() for x in (v1, e1, e2))
        dev = v1.device
        p1, p2 = v1 + e1, v1 + e2
        lo = torch.minimum(torch.minimum(v1, p1), p2)
        hi = torch.maximum(torch.maximum(v1, p1), p2)
        F = v1.shape[0]
        P = 1 << max(0, math.ceil(math.log2(-(-F // LEAF))))
        inf = torch.tensor(float("inf"), device=dev)
        # padding slots: centres at +inf, so they sort to the end of a node
        cent = torch.cat([0.5 * (lo + hi),
                          inf.expand(P * LEAF - F, 3)])
        order = torch.arange(P * LEAF, device=dev)
        rows = 1
        while rows < P:
            c = cent[order].reshape(rows, -1, 3)
            real = torch.isfinite(c)
            ext = (torch.where(real, c, -inf).amax(1)
                   - torch.where(real, c, inf).amin(1))
            axis = torch.nan_to_num(ext, nan=0.0, neginf=0.0).argmax(1)
            key = c.gather(2, axis[:, None, None].expand(-1, c.shape[1], 1))
            idx = torch.sort(key[..., 0], dim=1, stable=True).indices
            order = order.reshape(rows, -1).gather(1, idx).reshape(-1)
            rows *= 2
        tris = torch.where(order < F, order, -1).reshape(P, LEAF)
        valid = (tris >= 0)[..., None]
        node_lo = torch.empty((2 * P, 3), device=dev)
        node_hi = torch.empty((2 * P, 3), device=dev)
        node_lo[P:] = torch.where(valid, lo[tris.clamp_min(0)], inf).amin(1)
        node_hi[P:] = torch.where(valid, hi[tris.clamp_min(0)], -inf).amax(1)
        n = P
        while n > 1:
            a = n // 2
            node_lo[a:n] = torch.minimum(node_lo[n:2 * n:2],
                                         node_lo[n + 1:2 * n:2])
            node_hi[a:n] = torch.maximum(node_hi[n:2 * n:2],
                                         node_hi[n + 1:2 * n:2])
            n = a
        # an empty node's box is NaN, which every slab test misses
        empty = (node_lo > node_hi).any(1, keepdim=True)
        node_lo = torch.where(empty, float("nan"), node_lo)
        node_hi = torch.where(empty, float("nan"), node_hi)
        return Tree(node_lo.to(dtype), node_hi.to(dtype), tris, P,
                    int(math.log2(P)))


def _slab(o, inv, lo, hi):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin, tmax = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tn = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
    tf = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
    return tn, tf


@torch.no_grad()
def search(tree: Tree, geo, o, d, max_t, any_hit: bool):
    """Per lane the triangle with the least t in [0, max_t) (-1: none) and
    that t; ``any_hit``: some triangle in that range, the walk stopping at
    the first.  Lanes with max_t <= 0 hit nothing."""
    v1, e1, e2 = geo
    n = o.shape[0]
    dev = o.device
    best_t = max_t.clone()
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(max_t > 0).reshape(-1)
    A = lanes.shape[0]
    stack = torch.ones((A, tree.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((A,), dtype=torch.int64, device=dev)
    lo_o, lo_d = o[lanes], d[lanes]
    inv = 1.0 / lo_d
    P = tree.leaves
    while A > 0:
        ar = torch.arange(A, device=dev)
        node = stack[ar, sp - 1]
        sp = sp - 1
        bt = best_t[lanes]
        leaf = node >= P
        # a leaf: its triangles
        ids = tree.tris[torch.where(leaf, node - P, 0)]           # (A, L)
        ok = leaf[:, None] & (ids >= 0)
        safe = ids.clamp_min(0)
        t, _, _, h = triangle(lo_o[:, None], lo_d[:, None], v1[safe],
                              e1[safe], e2[safe])
        acc = ok & h & (t >= 0.0) & (t < bt[:, None])
        t = torch.where(acc, t, bt[:, None])
        tmin, j = t.min(1)
        won = acc.any(1)
        best_t[lanes] = torch.where(won, tmin, bt)
        best_p[lanes] = torch.where(won, ids[torch.arange(A, device=dev), j],
                                    best_p[lanes])
        bt = torch.where(won, tmin, bt)
        # an inner node: its children, tested now, the far one pushed first
        c0 = torch.where(leaf, 1, 2 * node)
        tn0, tf0 = _slab(lo_o, inv, tree.lo[c0], tree.hi[c0])
        tn1, tf1 = _slab(lo_o, inv, tree.lo[c0 + 1], tree.hi[c0 + 1])
        h0 = ~leaf & (tf0 >= tn0) & (tn0 < bt) & (tf0 >= 0.0)
        h1 = ~leaf & (tf1 >= tn1) & (tn1 < bt) & (tf1 >= 0.0)
        first_far = torch.where(tn1 < tn0, c0, c0 + 1)
        near = torch.where(tn1 < tn0, c0 + 1, c0)
        both = h0 & h1
        one = torch.where(h0, c0, c0 + 1)
        stack[ar, sp] = torch.where(both, first_far, one)
        sp = sp + (h0 | h1).long()
        stack[ar, sp.clamp_max(stack.shape[1] - 1)] = torch.where(
            both, near, stack[ar, sp.clamp_max(stack.shape[1] - 1)])
        sp = sp + both.long()
        if any_hit:
            sp = torch.where(won, 0, sp)
        keep = sp > 0
        if not bool(keep.all()):
            idx = torch.nonzero(keep).reshape(-1)
            lanes, stack, sp = lanes[idx], stack[idx], sp[idx]
            lo_o, lo_d, inv = lo_o[idx], lo_d[idx], inv[idx]
            A = lanes.shape[0]
    return best_p, best_t


# --------------------------------------------------------------- materials
def _lambert(cd, kd):
    return cd * (kd * (1.0 / math.pi))[..., None]


def _blinn(cs, ks, ex, n, wo, wi):
    h = normalize(wo + wi)
    hdotn = torch.clamp_min(dot(h, n), 0.0)
    spec = cs * ks[..., None]
    schlick = spec + (1.0 - spec) * torch.pow(
        1.0 - torch.clamp(dot(wi, h), 0.0, 1.0), 5.0)[..., None]
    return schlick * ((ex + 2.0) / (8.0 * math.pi)
                      * torch.pow(hdotn, ex))[..., None]


def shade(m, n, wo, wi, light):
    ndotl = torch.clamp_min(dot(n, wi), 0.0)[..., None]
    f = _lambert(m["cd"], m["kd"])
    f = torch.where((m["type"] == PLASTIC)[..., None],
                    f + _blinn(m["cs"], m["ks"], m["exp"], n, wo, wi), f)
    return math.pi * f * light * ndotl


def sample(m, n, wo, u_lobe, u1, u2):
    """(f, wi, pdf) of the material's importance sample."""
    bu, bv = basis(n)
    r = torch.sqrt(u1)
    th = 2.0 * math.pi * u2
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    wi_d = normalize((r * torch.cos(th))[..., None] * bu
                     + (r * torch.sin(th))[..., None] * bv + z[..., None] * n)
    pdf_d = dot(n, wi_d) * (1.0 / math.pi)
    f_d = _lambert(m["cd"], m["kd"])

    ex = m["exp"]
    ct = torch.pow(u1, 1.0 / (ex + 1.0))
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    ph = u2 * 2.0 * math.pi
    h = normalize((st * torch.cos(ph))[..., None] * bu
                  + (st * torch.sin(ph))[..., None] * bv + ct[..., None] * n)
    wi_s = reflect(wo, h)
    vdoth = dot(wo, h)
    pdf_s = torch.where(vdoth != 0.0, (ex + 1.0) * torch.pow(ct, ex)
                        / (2.0 * math.pi * 4.0
                           * torch.where(vdoth != 0.0, vdoth, 1.0)), 0.0)
    f_s = _blinn(m["cs"], m["ks"], ex, n, wo, wi_s)

    pd = m["cd"].mean(-1) * m["kd"]
    ps = m["cs"].mean(-1) * m["ks"]
    zero = (pd == 0.0) & (ps == 0.0)
    pd, ps = torch.where(zero, 0.5, pd), torch.where(zero, 0.5, ps)
    diffuse = (m["type"] == MATTE) | (u_lobe < pd / (pd + ps))
    f = torch.where(diffuse[..., None], f_d, f_s)
    wi = torch.where(diffuse[..., None], wi_d, wi_s)
    return f, wi, torch.where(diffuse, pdf_d, pdf_s)


# ------------------------------------------------------------------- scene
@dataclass
class Scene:
    """Everything the reference renders, in one precision."""

    verts: torch.Tensor     # (V, 3), a leaf that may require grad
    faces: torch.Tensor     # (F, 3) int64
    mat_ids: torch.Tensor   # (F,) int64
    normals: torch.Tensor   # (F, 3) face normals of the vertices as made
    mats: dict              # type (M,), cd ca cs (M, 3), kd ks exp ka (M,)
    lights: dict            # position, cl (L, 3), kl (L,), att (L, 3)
    cam: dict               # eye, center, up, fovy, aspect
    eps: float
    bg: tuple
    ambient: tuple
    tree: Tree
    dtype: torch.dtype


def make_scene(verts, faces, mat_ids, config: dict, cam: dict, device,
               dtype=torch.float32) -> Scene:
    """The reference's scene from the generated arrays and a
    configuration's ``materials``, ``lights`` and ``render`` sections."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=device).to(dtype)
    verts = f(verts)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    v1, v2, v3 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    mats = config["materials"]
    kinds = {"matte": MATTE, "plastic": PLASTIC}
    table = dict(
        type=torch.tensor([kinds[m["type"]] for m in mats], device=device),
        cd=f([m["cd"] for m in mats]), kd=f([m["kd"] for m in mats]),
        cs=f([m.get("cs", (0.0, 0.0, 0.0)) for m in mats]),
        ks=f([m.get("ks", 0.0) for m in mats]),
        exp=f([m.get("specular_exp", 1.0) for m in mats]))
    lights = config["lights"]
    light = dict(position=f([x["position"] for x in lights]),
                 cl=f([x["cl"] for x in lights]),
                 kl=f([x["kl"] for x in lights]),
                 att=f([x.get("attenuation", (1.0, 0.0, 0.0))
                        for x in lights]))
    r = config["render"]
    return Scene(verts=verts, faces=faces,
                 mat_ids=torch.as_tensor(mat_ids, dtype=torch.int64,
                                         device=device),
                 normals=normalize(cross(v2 - v1, v3 - v1)), mats=table,
                 lights=light, cam=cam, eps=float(r["epsilon"]),
                 bg=tuple(r["bg_color"]), ambient=tuple(r["ambient"][:3]),
                 tree=build_tree(v1, v2 - v1, v3 - v1, dtype), dtype=dtype)


def primary_rays(cam: dict, x, y, width, height, jitter, dtype):
    dev = x.device
    t = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    f = normalize(t(cam["eye"]) - t(cam["center"]))
    s = normalize(cross(t(cam["up"]), f))
    u = cross(f, s)
    th = torch.tan(t(cam["fovy"]) / 2.0)
    cu, cv, cw = s * th * t(cam["aspect"]), u * th, -f
    px = 2.0 * (x.float() + jitter[0] + 0.5) / width - 1.0
    py = 2.0 * (y.float() + jitter[1] + 0.5) / height - 1.0
    d = normalize(cu * px[..., None] + cv * py[..., None] + cw)
    return t(cam["eye"]).expand(d.shape).to(dtype), d.to(dtype)


def render(scene: Scene, x, y, width: int, height: int, frame: int,
           bounces: int, cd=None):
    """(N, 4) colours of pixels (x, y) of ``frame``: one sample a pixel
    through the NEE path tracer.  ``cd``: the diffuse colours (M, 3) to
    use (a leaf that may require grad), else the scene's."""
    dt = scene.dtype
    dev = x.device
    n = x.shape[0]
    verts = scene.verts
    v1 = verts[scene.faces[:, 0]]
    e1 = verts[scene.faces[:, 1]] - v1
    e2 = verts[scene.faces[:, 2]] - v1
    geo = (v1.detach(), e1.detach(), e2.detach())
    mats = dict(scene.mats, cd=scene.mats["cd"] if cd is None else cd)
    pid = ((y.long() * width + x.long()) & MASK)
    state = sampler_state(pid, frame)
    (jx, jy), state = draws(state, 2, torch.float32)
    o, d = primary_rays(scene.cam, x, y, width, height,
                        (jx - 0.5, jy - 0.5), dt)
    amb = torch.tensor(scene.ambient, dtype=dt, device=dev)
    light = scene.lights
    L = light["position"].shape[0]
    active = torch.ones(n, dtype=torch.bool, device=dev)
    dst = torch.ones((n, 3), dtype=dt, device=dev)
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    first_hit = None
    for b in range(bounces):
        mt = torch.where(active, torch.tensor(FLT_MAX, dtype=dt, device=dev),
                         torch.tensor(-1.0, dtype=dt, device=dev))
        prim, _ = search(scene.tree, geo, o.detach(), d.detach(), mt, False)
        hit = prim >= 0
        p = prim.clamp_min(0)
        t, _, _, _ = triangle(o, d, v1[p], e1[p], e2[p])
        t = torch.where(hit, t, 1.0)
        acc = torch.where((active & ~hit)[..., None], acc + dst * amb, acc)
        active = active & hit
        if b == 0:
            first_hit = hit
        m = {k: v[scene.mat_ids[p]] for k, v in mats.items()}
        wo = -d
        ng = scene.normals[p]
        n_ = torch.where((dot(ng, wo) < 0.0)[..., None], -ng, ng)
        (u_lobe, u1, u2, ul, _, _), state = draws(state, 6, dt)
        f, wi_b, pdf = sample(m, n_, wo, u_lobe, u1, u2)
        zero_pdf = pdf <= 0.0
        pos = o + d * t[..., None]

        # next-event estimate: one light picked uniformly
        sel = torch.clamp_max((ul * L).to(torch.int32), L - 1).long()
        lp = light["position"][sel]
        to = lp - pos
        dist = torch.sqrt(dot(to, to))
        wl = to / torch.clamp_min(dist, 1e-12)[..., None]
        att = light["att"][sel]
        inten = light["cl"][sel] * (light["kl"][sel] / (
            att[..., 0] + att[..., 1] * dist + att[..., 2] * dist * dist)
        )[..., None]
        fire = (dot(n_, wl) > 0.0) & active
        smt = torch.where(fire, dist - 2.0 * scene.eps,
                          torch.tensor(-1.0, dtype=dt, device=dev))
        blocked, _ = search(scene.tree, geo, (lp - wl * scene.eps).detach(),
                            (-wl).detach(), smt.detach(), True)
        visible = fire & (blocked < 0)
        direct = shade(m, n_, wo, wl, inten) * (visible.to(dt) * L)[..., None]
        acc = torch.where(active[..., None], acc + dst * direct, acc)

        w = dot(n_, wi_b) / torch.where(zero_pdf, 1.0, pdf)
        dst = torch.where((active & ~zero_pdf)[..., None],
                          dst * (f * w[..., None]), dst)
        dst = torch.where((zero_pdf & active)[..., None], 0.0, dst)
        active = active & ~zero_pdf
        o, d = pos + wi_b * scene.eps, wi_b
    bg = torch.tensor(scene.bg, dtype=dt, device=dev)
    rgba = torch.cat([acc, torch.ones_like(acc[..., :1])], -1)
    return torch.where(first_hit[..., None], rgba, bg)


def loss_and_grads(scene: Scene, x, y, width: int, height: int, frame: int,
                   bounces: int, n_pixels: int, block: int = 1 << 21):
    """The training loss sum(rgb) / (n_pixels * 3) over lanes (x, y) and
    its gradients to the vertices and the diffuse colours, accumulated
    over blocks of lanes (float64 sums)."""
    verts = scene.verts.detach().requires_grad_()
    cd = scene.mats["cd"].detach().requires_grad_()
    s = dict(vars(scene))
    s["verts"] = verts
    sc = Scene(**s)
    loss = 0.0
    gv = torch.zeros(verts.shape, dtype=torch.float64, device=x.device)
    gc = torch.zeros(cd.shape, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], block):
        c = render(sc, x[i:i + block], y[i:i + block], width, height, frame,
                   bounces, cd=cd)
        part = c[..., :3].sum() / (n_pixels * 3)
        g = torch.autograd.grad(part, (verts, cd))
        loss += float(part.detach().double())
        gv += g[0].double()
        gc += g[1].double()
    return loss, gv, gc
