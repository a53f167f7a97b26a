"""Volume ray marching (port of kernels/volume.py; reference
examples/volume/main.cpp and examples/multi_volume/main.cpp:376-690).

Each volume is an AABB-bounded scalar field of (D, H, W) texels, sampled
trilinearly and classified through an RGBA transfer table, composited
front to back:

    while t < tfar:  s = tex3D(vol, p); c = transfer(s)
                     dst += (1 - dst.a) * c;  t += dt

With V > 1 volumes every ray marches them in its own nearest-first order
(the stable argsort of the entry distances; missed volumes last), the
reference's bounding-box compositing order resolved per ray.

The march runs through ``volume_march``:

- on CUDA tensors it launches ``vsnray_volume_march``
  (``ops/cuda/volume_march.cu``, built into the library of
  ops/traverse.py) and adds one to ``LAUNCHES["volume_march"]`` and
  ``ENTRY_LAUNCHES["vsnray_volume_march"]``; the kernel stops a ray's march
  at its first masked step;
- on CPU tensors it runs ``march_plain``, the JAX function line for line,
  every one of the 512 masked steps of every rank.

Gradients: the plain version is differentiable with respect to texels,
transfer, background, rays and boxes.  On the card, where any of them
requires grad, the forward also saves each ray's composite before the
background (it cannot be recovered from the colour where bg.a = 1), and
the backward is one launch of ``vsnray_volume_march_bwd``
(``ops/cuda/volume_march_bwd.cu``: each ray marched again; texel,
transfer and box gradients by atomic adds, the rays' own by their
threads; counted in ``LAUNCHES["volume_march_bwd"]`` and its entry point)
and a PyTorch reduction for the background.  The depth (the least entry
of the boxes hit) is the kernel's value; its gradient to rays and boxes
is the plain slab test's under autograd.  Atomic adds make those
gradients vary in their last bits from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

import visionaray_torch.ops.traverse as trav
from visionaray_torch.core.types import Ray, ResultRecord
from visionaray_torch.device import resolve_device
from visionaray_torch.ops.intersect import intersect_aabb

MAX_STEPS = 512
ENTRY = "vsnray_volume_march"
ENTRY_BWD = "vsnray_volume_march_bwd"
_EXIT_EVERY = 16   # march_plain(early_exit=True): steps between checks


@dataclass
class Volumes:
    """One or more AABB-bounded scalar volumes with transfer functions;
    all share one (D, H, W) and one table length T."""

    lo: Any        # (V, 3) box lower corners
    hi: Any        # (V, 3)
    texels: Any    # (V, D, H, W) f32 in [0, 1]
    transfer: Any  # (V, T, 4) RGBA transfer function

    @staticmethod
    def create(lo, hi, texels, transfer, device="cuda") -> "Volumes":
        """``texels`` (D, H, W) or (V, D, H, W), ``transfer`` (T, 4) or
        (V, T, 4).  Refuses 2^31 texels or more (the kernel's flat index
        is an int32)."""
        dev = resolve_device(device)
        texels = torch.as_tensor(texels, dtype=torch.float32, device=dev)
        transfer = torch.as_tensor(transfer, dtype=torch.float32, device=dev)
        if texels.ndim == 3:
            texels = texels[None]
        if transfer.ndim == 2:
            transfer = transfer[None]
        if texels.numel() >= 2 ** 31:
            raise ValueError(f"Volumes: {texels.numel()} texels; the march "
                             f"indexes at most 2^31 - 1")
        return Volumes(
            lo=torch.as_tensor(lo, dtype=torch.float32,
                               device=dev).reshape(-1, 3),
            hi=torch.as_tensor(hi, dtype=torch.float32,
                               device=dev).reshape(-1, 3),
            texels=texels, transfer=transfer)

    @property
    def num_volumes(self):
        return self.lo.shape[0]


def _tex3d_multi(texels, vi, u, v, w):
    """Trilinear fetch (CLAMP) of (V, D, H, W) texels with a per-lane
    volume index ``vi``."""
    V, D, H, W = texels.shape
    x = u * W - 0.5
    y = v * H - 0.5
    z = w * D - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    z0 = torch.floor(z).to(torch.int32)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    flat = texels.reshape(-1)
    base = vi.long() * D

    def fetch(xi, yi, zi):
        xi = torch.clamp(xi, 0, W - 1).long()
        yi = torch.clamp(yi, 0, H - 1).long()
        zi = torch.clamp(zi, 0, D - 1).long()
        return flat[((base + zi) * H + yi) * W + xi]

    out = 0.0
    for dz in (0, 1):
        wz = (1 - fz) if dz == 0 else fz
        for dy in (0, 1):
            wy = (1 - fy) if dy == 0 else fy
            for dx in (0, 1):
                wx = (1 - fx) if dx == 0 else fx
                out = out + wz * wy * wx * fetch(x0 + dx, y0 + dy, z0 + dz)
    return out


def _tex1d_multi(transfer, vi, u):
    """Linear fetch (CLAMP) of (V, T, C) transfer tables with a per-lane
    volume index."""
    V, T, C = transfer.shape
    x = u * T - 0.5
    x0 = torch.floor(x).to(torch.int32)
    fx = (x - x0)[..., None]
    flat = transfer.reshape(-1, C)

    def fetch(xi):
        return flat[vi.long() * T + torch.clamp(xi, 0, T - 1).long()]

    return (1 - fx) * fetch(x0) + fx * fetch(x0 + 1)


def _entries(o, d, lo, hi):
    """Entry and exit of every box, (V, N) each: (tn, tf, hit), and the
    rays' (any_hit, depth), depth the least tn of the boxes hit, else 0."""
    inv_d = 1.0 / d
    tn_all, tf_all, hit_all = intersect_aabb(o[None], inv_d[None],
                                             lo[:, None], hi[:, None])
    tn_all = torch.maximum(tn_all, torch.zeros_like(tn_all))
    hit_all = hit_all & (tf_all >= tn_all)
    inf = torch.full_like(tn_all, float("inf"))
    any_hit = torch.any(hit_all, dim=0)
    depth = torch.amin(torch.where(hit_all, tn_all, inf), dim=0)
    depth = torch.where(any_hit, depth, 0.0)
    return tn_all, tf_all, hit_all, any_hit, depth


def march_plain(o, d, volumes: Volumes, bg, step_scale: float = 1.0,
                early_exit: bool = False):
    """The march of lanes ``o``, ``d`` (N, 3) through ``volumes``: (color
    (N, 4), hit (N,), depth (N,)), as JAX computes them: every rank runs
    all MAX_STEPS steps, masked.  ``early_exit``: a rank ends once no lane
    is live any more (a test of the kernel's break)."""
    lo, hi = volumes.lo, volumes.hi
    texels, transfer = volumes.texels, volumes.transfer
    V = lo.shape[0]
    dst = torch.zeros((o.shape[0], 4), dtype=torch.float32, device=o.device)
    tn_all, tf_all, hit_all, any_hit, depth = _entries(o, d, lo, hi)
    inf = torch.full_like(tn_all, float("inf"))
    order = torch.argsort(torch.where(hit_all, tn_all, inf), dim=0,
                          stable=True)

    D3 = torch.tensor(texels.shape[1:4], dtype=torch.float32,
                      device=o.device)
    zero = torch.zeros((), dtype=torch.float32, device=o.device)
    one = torch.ones((), dtype=torch.float32, device=o.device)
    for r in range(V):
        vi = order[r]
        lo_v = lo[vi]
        extent = hi[vi] - lo_v
        tn = torch.gather(tn_all, 0, vi[None])[0]
        tf = torch.gather(tf_all, 0, vi[None])[0]
        inside = torch.gather(hit_all, 0, vi[None])[0]
        # the step: one voxel of the smallest axis ratio (JAX's comment
        # says half a voxel; extent x pairs with D, as JAX's does)
        dt = step_scale * torch.amin(extent / D3, dim=-1)
        for i in range(MAX_STEPS):
            t = tn + dt * i
            live = inside & (t < tf) & (dst[:, 3] < 0.999)
            if early_exit and i % _EXIT_EVERY == 0 and not bool(live.any()):
                break
            p = o + d * t[:, None]
            uvw = (p - lo_v) / extent
            s = _tex3d_multi(texels, vi, uvw[:, 0], uvw[:, 1], uvw[:, 2])
            c = _tex1d_multi(transfer, vi, s)
            # opacity correction for the step, then front to back; clipped
            # as jnp.clip is (maximum, then minimum), so an argument exactly
            # on a bound takes half the gradient (torch.clamp takes all)
            a = torch.minimum(torch.maximum(c[:, 3] * dt * D3[0], zero), one)
            contrib = torch.cat([c[:, :3] * a[:, None], a[:, None]], dim=-1)
            new_dst = dst + (1.0 - dst[:, 3:4]) * contrib
            dst = torch.where(live[:, None], new_dst, dst)
    color = dst + (1.0 - dst[:, 3:4]) * bg
    return color, any_hit, depth


def _check(o, d, volumes: Volumes, bg):
    V = volumes.lo.shape[0]
    if volumes.texels.ndim != 4 or volumes.transfer.ndim != 3 \
            or volumes.transfer.shape[-1] != 4:
        raise ValueError("volume_march: texels must be (V, D, H, W) and "
                         "transfer (V, T, 4)")
    want = [("o", o, (o.shape[0], 3)), ("d", d, (o.shape[0], 3)),
            ("lo", volumes.lo, (V, 3)), ("hi", volumes.hi, (V, 3)),
            ("texels", volumes.texels, (V,) + tuple(volumes.texels.shape[1:])),
            ("transfer", volumes.transfer,
             (V,) + tuple(volumes.transfer.shape[1:])),
            ("bg", bg, (4,))]
    for name, x, shape in want:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"volume_march: {name} must be float32 {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"volume_march: {name} is on {x.device}, rays "
                             f"on {o.device}")
    if volumes.texels.numel() >= 2 ** 31:
        raise ValueError("volume_march: 2^31 texels or more")


def _launch(o, d, volumes: Volumes, bg, step_scale, steps=None,
            save_dst=False):
    """One vsnray_volume_march launch: (color, hit, depth, dst or None)."""
    n = o.shape[0]
    color = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    hit = torch.empty((n,), dtype=torch.bool, device=o.device)
    depth = torch.empty((n,), dtype=torch.float32, device=o.device)
    dst = torch.empty((n, 4), dtype=torch.float32, device=o.device) \
        if save_dst else None
    if n == 0:
        return color, hit, depth, dst
    V, D, H, W = volumes.texels.shape
    args = [x.detach().contiguous() for x in (
        o, d, volumes.lo, volumes.hi, volumes.texels, volumes.transfer, bg)]
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = trav._library().vsnray_volume_march(
            *[x.data_ptr() for x in args], color.data_ptr(), hit.data_ptr(),
            depth.data_ptr(), None if dst is None else dst.data_ptr(),
            None if steps is None else steps.data_ptr(), n, V, D, H, W,
            volumes.transfer.shape[1], float(step_scale), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: cudaError {err}")
    trav.LAUNCHES["volume_march"] += 1
    trav.ENTRY_LAUNCHES[ENTRY] += 1
    return color, hit, depth, dst


_GRADS = ("o", "d", "lo", "hi", "texels", "transfer")


def march_backward(o, d, volumes: Volumes, bg, dst, gcolor,
                   step_scale: float = 1.0, wanted=_GRADS, counts=None):
    """The gradients of one march's colour, a dict over the names in
    ``wanted`` (of ``o``, ``d`` (N, 3), ``lo``, ``hi`` (V, 3), ``texels``,
    ``transfer``), from its saved composite ``dst`` (N, 4) and ``gcolor``
    = dL/dcolor (N, 4): one launch of vsnray_volume_march_bwd on CUDA
    tensors (it marches each ray again).  A gradient not asked for costs
    the kernel none of its atomics.  The kernel sums the transfer and box
    gradients in a block's shared memory: it refuses tables of more
    entries (V * T * 4 + V * 6) than that holds in f64 (29,056 on the
    H100).  ``counts``: an optional (1,) int64 tensor on the rays' device
    that the kernel adds its shared-memory transfer adds to."""
    if o.device.type != "cuda":
        raise ValueError(f"march_backward: no kernel for {o.device}")
    if counts is not None and (tuple(counts.shape) != (1,)
                               or counts.dtype != torch.int64
                               or counts.device != o.device):
        raise ValueError("march_backward: counts must be int64 (1,) on the "
                         "rays' device")
    n = o.shape[0]
    V, D, H, W = volumes.texels.shape

    def zeros(want, shape, dtype=torch.float32):
        return torch.zeros(tuple(shape), dtype=dtype, device=o.device) \
            if want else None

    out = {"texels": zeros("texels" in wanted, volumes.texels.shape),
           # the transfer entries and the boxes sum millions of terms: the
           # kernel adds them in f64
           "transfer": zeros("transfer" in wanted, volumes.transfer.shape,
                             torch.float64),
           "o": zeros("o" in wanted, o.shape),
           "d": zeros("d" in wanted, d.shape)}
    gbox = zeros("lo" in wanted or "hi" in wanted, (V, 6), torch.float64)
    if n > 0:
        args = [x.detach().contiguous() for x in (
            o, d, volumes.lo, volumes.hi, volumes.texels, volumes.transfer,
            bg, dst, gcolor.to(torch.float32))]
        outs = [out["texels"], out["transfer"], out["o"], out["d"], gbox]
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream(o.device).cuda_stream
            err = trav._library().vsnray_volume_march_bwd(
                *[x.data_ptr() for x in args],
                *[None if x is None else x.data_ptr() for x in outs],
                None if counts is None else counts.data_ptr(),
                n, V, D, H, W, volumes.transfer.shape[1], float(step_scale),
                stream)
        if err != 0:
            raise RuntimeError(
                f"{ENTRY_BWD} launch failed: cudaError {err} (transfer "
                f"tables of {volumes.transfer.numel()} entries; a block "
                f"sums at most its shared memory's worth of f64)")
        trav.LAUNCHES["volume_march_bwd"] += 1
        trav.ENTRY_LAUNCHES[ENTRY_BWD] += 1
    if out["transfer"] is not None:
        out["transfer"] = out["transfer"].float()
    if gbox is not None:
        out["lo"], out["hi"] = gbox[:, :3].float(), gbox[:, 3:].float()
    return {k: out[k] for k in wanted}


class _KernelMarch(torch.autograd.Function):
    """The card's march with its backward kernel: the colour's gradients
    with respect to rays, boxes, texels, transfer and background (the
    depth is returned without one: ``volume_march`` adds it)."""

    @staticmethod
    def forward(ctx, o, d, lo, hi, texels, transfer, bg, step_scale):
        vols = Volumes(lo=lo, hi=hi, texels=texels, transfer=transfer)
        color, hit, depth, dst = _launch(o, d, vols, bg, step_scale,
                                         save_dst=True)
        ctx.save_for_backward(o, d, lo, hi, texels, transfer, bg, dst)
        ctx.step_scale = step_scale
        ctx.mark_non_differentiable(hit, depth)
        return color, hit, depth

    @staticmethod
    def backward(ctx, gcolor, _ghit, _gdepth):
        o, d, lo, hi, texels, transfer, bg, dst = ctx.saved_tensors
        need = ctx.needs_input_grad
        wanted = tuple(k for k, w in zip(_GRADS, need[:6]) if w)
        grads = {}
        if wanted:
            grads = march_backward(
                o, d, Volumes(lo=lo, hi=hi, texels=texels,
                              transfer=transfer),
                bg, dst, gcolor, ctx.step_scale, wanted)
        gbg = ((1.0 - dst[:, 3:4]) * gcolor).sum(dim=0) if need[6] else None
        return (*[grads.get(k) for k in _GRADS], gbg, None)


def volume_march(o, d, volumes: Volumes, bg, step_scale: float = 1.0,
                 steps=None):
    """(color (N, 4), hit (N,), depth (N,)) of lanes ``o``, ``d`` (N, 3)
    f32.  CUDA tensors launch the kernel (``steps``: an optional (N,) int32
    tensor it fills with each ray's steps taken), and its backward kernel
    where rays, boxes, texels, transfer or bg require grad; CPU tensors
    run ``march_plain``."""
    _check(o, d, volumes, bg)
    if o.device.type == "cpu":
        return march_plain(o, d, volumes, bg, step_scale)
    if o.device.type != "cuda":
        raise ValueError(f"volume_march: no kernel for {o.device}")
    if steps is not None and (tuple(steps.shape) != (o.shape[0],)
                              or steps.dtype != torch.int32
                              or steps.device != o.device):
        raise ValueError("volume_march: steps must be int32 (n,) on the "
                         "rays' device")
    inputs = (o, d, volumes.lo, volumes.hi, volumes.texels,
              volumes.transfer, bg)
    if not (torch.is_grad_enabled() and any(x.requires_grad
                                            for x in inputs)):
        return _launch(o, d, volumes, bg, step_scale, steps)[:3]
    if steps is not None:
        raise ValueError("volume_march: the counting form takes no "
                         "gradient")
    color, hit, depth = _KernelMarch.apply(*inputs, float(step_scale))
    if any(x.requires_grad for x in inputs[:4]):
        # the kernel's depth, with the plain slab test's gradient
        plain = _entries(o, d, volumes.lo, volumes.hi)[4]
        depth = depth + (plain - plain.detach())
    return color, hit, depth


def volume_kernel(params, ray: Ray, sampler=None, volumes: Volumes = None,
                  step_scale: float = 1.0) -> ResultRecord:
    """March every volume front to back in each ray's depth order;
    ``volumes`` defaults to ``params.scene.volumes``."""
    vols = volumes if volumes is not None else params.scene.volumes
    if vols is None:
        raise ValueError("volume_kernel needs a Volumes instance "
                         "(scene.volumes or the volumes argument)")
    batch = ray.batch_shape
    color, hit, depth = volume_march(
        ray.ori.reshape(-1, 3), ray.dir.reshape(-1, 3), vols,
        params.bg_color, step_scale)
    return ResultRecord(color=color.reshape(batch + (4,)),
                        hit=hit.reshape(batch), depth=depth.reshape(batch))
