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

The kernel has no backward pass: ``volume_march`` refuses CUDA inputs that
require grad (ROADMAP queue 1, item 6b); the plain version is
differentiable with respect to texels, transfer and rays.
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
    inv_d = 1.0 / d

    # entry and exit of every volume: (V, N)
    tn_all, tf_all, hit_all = intersect_aabb(o[None], inv_d[None],
                                             lo[:, None], hi[:, None])
    tn_all = torch.maximum(tn_all, torch.zeros_like(tn_all))
    hit_all = hit_all & (tf_all >= tn_all)
    inf = torch.full_like(tn_all, float("inf"))
    any_hit = torch.any(hit_all, dim=0)
    depth = torch.amin(torch.where(hit_all, tn_all, inf), dim=0)
    depth = torch.where(any_hit, depth, 0.0)
    order = torch.argsort(torch.where(hit_all, tn_all, inf), dim=0,
                          stable=True)

    D3 = torch.tensor(texels.shape[1:4], dtype=torch.float32,
                      device=o.device)
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
            # opacity correction for the step, then front to back
            a = torch.clamp(c[:, 3] * dt * D3[0], 0.0, 1.0)
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


def volume_march(o, d, volumes: Volumes, bg, step_scale: float = 1.0,
                 steps=None):
    """(color (N, 4), hit (N,), depth (N,)) of lanes ``o``, ``d`` (N, 3)
    f32.  CUDA tensors launch the kernel (``steps``: an optional (N,) int32
    tensor it fills with each ray's steps taken); CPU tensors run
    ``march_plain``."""
    _check(o, d, volumes, bg)
    if o.device.type == "cpu":
        return march_plain(o, d, volumes, bg, step_scale)
    if o.device.type != "cuda":
        raise ValueError(f"volume_march: no kernel for {o.device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (o, d, volumes.lo, volumes.hi,
                                      volumes.texels, volumes.transfer, bg)):
        raise NotImplementedError(
            "volume_march: the CUDA march has no backward pass yet (ROADMAP "
            "queue 1, item 6b: texel and transfer gradients); differentiate "
            "on the CPU, where the plain version runs")
    n = o.shape[0]
    color = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    hit = torch.empty((n,), dtype=torch.bool, device=o.device)
    depth = torch.empty((n,), dtype=torch.float32, device=o.device)
    if n == 0:
        return color, hit, depth
    if steps is not None and (tuple(steps.shape) != (n,)
                              or steps.dtype != torch.int32
                              or steps.device != o.device):
        raise ValueError("volume_march: steps must be int32 (n,) on the "
                         "rays' device")
    V, D, H, W = volumes.texels.shape
    args = [x.contiguous() for x in (o, d, volumes.lo, volumes.hi,
                                     volumes.texels, volumes.transfer, bg)]
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = trav._library().vsnray_volume_march(
            *[x.data_ptr() for x in args], color.data_ptr(), hit.data_ptr(),
            depth.data_ptr(), None if steps is None else steps.data_ptr(),
            n, V, D, H, W, volumes.transfer.shape[1], float(step_scale),
            stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: cudaError {err}")
    trav.LAUNCHES["volume_march"] += 1
    trav.ENTRY_LAUNCHES[ENTRY] += 1
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
