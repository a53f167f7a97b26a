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
  ops/traverse.py) and adds one to ``LAUNCHES["volume_march"]``,
  ``ENTRY_LAUNCHES["vsnray_volume_march"]`` and the launch's transfer form
  in ``VARIANT_LAUNCHES``; the kernel stops a ray's march at its first
  masked step, and skips the fetches of a step whose brick
  ``volume_pack``'s table marks empty (its colour is unchanged by them).
  The table is built on the card by ``vsnray_volume_bricks`` (counted in
  ``LAUNCHES["volume_bricks"]``) once per texels and transfer;
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

import weakref
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

import visionaray_torch.ops.traverse as trav
from visionaray_torch.core.types import Ray, ResultRecord
from visionaray_torch.device import resolve_device
from visionaray_torch.ops.intersect import intersect_aabb
from visionaray_torch.ops.traversal import _cache_of, _version

MAX_STEPS = 512
ENTRY = "vsnray_volume_march"
ENTRY_BWD = "vsnray_volume_march_bwd"
ENTRY_BRICKS = "vsnray_volume_bricks"
_EXIT_EVERY = 16   # march_plain(early_exit=True): steps between checks
BRICK = 4                  # cells a side of the march's empty bricks, 2^k
TR_SMEM_MAX = 48 * 1024    # transfer bytes a block holds (volume_march.cu)
_XT_LIMIT = 2.0 ** 30      # |transfer coordinate| the skip allows
_ENTRY_LIMIT = 2.0 ** 100  # |transfer value| an empty entry may have


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


def brick_minmax(padded, brick: int):
    """(lo, hi): the min and the max of the texels over each brick's
    window, texels [B b, B b + B] of every axis clamped to the grid:
    (V, nbz, nby, nbx) each, nb = ceil(n / B), from ``padded``
    (pad_texels: its high border is texel n, a copy of n - 1, and a
    window clipped at n + 1 covers the rest of the clamp).  NaN
    propagates (max pooling's rule)."""
    x = padded[:, None, 1:, 1:, 1:]
    hi = F.max_pool3d(x, brick + 1, brick, ceil_mode=True)
    lo = -F.max_pool3d(-x, brick + 1, brick, ceil_mode=True)
    return lo[:, 0], hi[:, 0]


def brick_table(texels, transfer, brick: int = BRICK, padded=None):
    """(V, nbz, nby, nbx) bool: True where a brick of ``brick``^3 cells is
    empty, so that the march may skip a step whose base cell (each axis
    clamped into the grid) lies in it: every transfer value such a step
    can classify has alpha <= 0 and finite RGB.

    Its trilinear corners lie in texels [B b, B b + B] of each axis
    (clamped), of range [lo, hi]; its sample s sums 8 products of those
    texels with weights in [0, 1] whose sum is 1 within 3 ulp, so s lies
    within 15 u M of [lo, hi] (u = 2^-24, M = max(|lo|, |hi|)), and the
    kernel's f32 xt = s T - 0.5 within 18 u (M T + 1) of [lo T - 0.5,
    hi T - 0.5]; e = 2^-16 (M T + 1) covers it.  So t0 = floor(xt) lies in
    [floor(lo T - 0.5 - e), floor(hi T - 0.5 + e)], t1 = t0 + 1, and
    clamped to [0, T - 1] both read entries of that range widened by one
    above.  A brick is empty when its texels are finite, |xt| stays below
    2^30 (t0 exact, ft in [0, 1]), and every entry of its range is
    finite, within 2^100 (the lerp of two cannot overflow) and of alpha
    <= 0 (so is the lerp's, and with dt finite and >= 0, which the kernel
    checks, the opacity is exactly 0).  A prefix count of the entries
    that are not answers each brick's range.  ``padded``:
    pad_texels(texels), where the caller holds it."""
    if padded is None:
        padded = pad_texels(texels)
    V = texels.shape[0]
    T = transfer.shape[1]
    lo, hi = (t.double() for t in brick_minmax(padded, brick))
    e = 2.0 ** -16 * (torch.maximum(lo.abs(), hi.abs()) * T + 1.0)
    a = lo * T - 0.5 - e
    b = hi * T - 0.5 + e
    fits = (a > -_XT_LIMIT) & (b < _XT_LIMIT)   # NaN and inf fail
    i0 = torch.floor(torch.where(fits, a, 0.0)).clamp(0, T - 1).long()
    i1 = (torch.floor(torch.where(fits, b, 0.0)) + 1).clamp(0, T - 1).long()
    prefix = bad_prefix(transfer)
    n_bad = (torch.gather(prefix, 1, i1.reshape(V, -1) + 1)
             - torch.gather(prefix, 1, i0.reshape(V, -1)))
    return fits & (n_bad == 0).reshape(i0.shape)


def bad_prefix(transfer):
    """(V, T + 1) int64: the count of transfer entries below each index
    that an empty brick may not reach (not finite, beyond 2^100 or of
    alpha > 0)."""
    tr = transfer.detach()
    good = (tr.abs() <= _ENTRY_LIMIT).all(-1) & (tr[..., 3] <= 0)
    return F.pad(torch.cumsum((~good).long(), dim=1), (1, 0))


def pack_bits(table):
    """A bool table as int32 words, bit j of word w = entry 32 w + j of
    the flat table (the kernel reads them unsigned)."""
    flat = table.reshape(-1).to(torch.int64)
    n = flat.numel()
    words = -(-n // 32)
    flat = F.pad(flat, (0, words * 32 - n)).reshape(words, 32)
    w = (flat << torch.arange(32, device=flat.device)).sum(dim=1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def pad_texels(texels):
    """(V, D+2, H+2, W+2): the texels with a replicated one-texel border."""
    return F.pad(texels.detach()[:, None], (1, 1, 1, 1, 1, 1),
                 mode="replicate")[:, 0].contiguous()


@dataclass
class VolumePack:
    """The march kernel's tables of one (texels, transfer) pair."""

    padded: Any    # (V, D+2, H+2, W+2) f32, pad_texels
    table: Any     # (V, nbz, nby, nbx) bool, brick_table
    bits: Any      # int32 words, pack_bits(table)
    brick: int


def brick_kernel(padded, transfer, brick: int):
    """(table, bits) of brick_table and pack_bits, by one
    vsnray_volume_bricks launch on CUDA tensors (counted in
    ``LAUNCHES["volume_bricks"]``)."""
    V = padded.shape[0]
    D, H, W = (n - 2 for n in padded.shape[1:])
    T = transfer.shape[1]
    nb = [-(-n // brick) for n in (D, H, W)]
    table = torch.empty((V, *nb), dtype=torch.bool, device=padded.device)
    bits = torch.zeros(-(-table.numel() // 32), dtype=torch.int32,
                       device=padded.device)
    prefix = bad_prefix(transfer).contiguous()
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = trav._library().vsnray_volume_bricks(
            padded.data_ptr(), prefix.data_ptr(), table.data_ptr(),
            bits.data_ptr(), V, D, H, W, T, brick.bit_length() - 1, nb[2],
            nb[1], nb[0], stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_BRICKS} launch failed: cudaError {err}")
    trav.LAUNCHES["volume_bricks"] += 1
    trav.ENTRY_LAUNCHES[ENTRY_BRICKS] += 1
    return table, bits


def build_pack(texels, transfer, brick: int = BRICK) -> VolumePack:
    """The kernel's tables of (texels, transfer), built anew: the brick
    table by ``brick_kernel`` on CUDA tensors, by ``brick_table`` on CPU
    tensors."""
    with torch.no_grad():
        padded = pad_texels(texels)
        if texels.device.type == "cpu":
            table = brick_table(texels, transfer, brick, padded)
            bits = pack_bits(table)
        elif texels.device.type == "cuda":
            table, bits = brick_kernel(padded, transfer, brick)
        else:
            raise ValueError(f"volume_pack: no kernel for {texels.device}")
        return VolumePack(padded=padded, table=table, bits=bits,
                          brick=brick)


def volume_pack(volumes: Volumes) -> VolumePack:
    """The kernel's padded texels and brick table of ``volumes`` (bricks
    of BRICK^3 cells), built on their device at first use and kept with
    the texels tensor: a later march reuses them while the texels and
    the transfer are the same tensors, unwritten (their ``_version``; an
    inference tensor keeps none, so there identity alone) and BRICK is
    the same.  An optimizer's in-place write gets a new pack."""
    brick = BRICK
    if brick < 1 or brick & (brick - 1):
        raise ValueError(f"volume_pack: brick {brick} is not a power of 2")
    texels, transfer = volumes.texels, volumes.transfer
    D, H, W = texels.shape[1:]
    if (D + 2) * (H + 2) * (W + 2) >= 2 ** 31:
        raise ValueError(f"volume_pack: a padded volume of {(D, H, W)} "
                         f"texels holds 2^31 or more; the kernel indexes "
                         f"one with an int32")
    cache = _cache_of(texels)
    key = (brick, _version(texels), _version(transfer))
    ref = cache.get("volume_transfer")
    if cache.get("volume_key") == key and ref is not None \
            and ref() is transfer:
        return cache["volume_pack"]
    pack = build_pack(texels, transfer, brick)
    cache.update(volume_key=key, volume_transfer=weakref.ref(transfer),
                 volume_pack=pack)
    return pack


def transfer_form(V: int, T: int) -> str:
    """Where the march kernel reads the transfer tables: ``shared`` when
    every table fits a block's TR_SMEM_MAX bytes, else ``global``."""
    return "shared" if V * T * 16 <= TR_SMEM_MAX else "global"


def _launch(o, d, volumes: Volumes, bg, step_scale, steps=None,
            save_dst=False, empty=None, warps=None, form=None):
    """One vsnray_volume_march launch: (color, hit, depth, dst or None).
    ``form``: the transfer form, ``transfer_form``'s by default."""
    n = o.shape[0]
    color = torch.empty((n, 4), dtype=torch.float32, device=o.device)
    hit = torch.empty((n,), dtype=torch.bool, device=o.device)
    depth = torch.empty((n,), dtype=torch.float32, device=o.device)
    dst = torch.empty((n, 4), dtype=torch.float32, device=o.device) \
        if save_dst else None
    if n == 0:
        return color, hit, depth, dst
    V, D, H, W = volumes.texels.shape
    T = volumes.transfer.shape[1]
    form = transfer_form(V, T) if form is None else form
    if form not in ("shared", "global") or (
            form == "shared" and V * T * 16 > TR_SMEM_MAX):
        raise ValueError(f"volume_march: no transfer form {form!r} for "
                         f"{V} tables of {T} entries")
    pack = volume_pack(volumes)
    nbz, nby, nbx = pack.table.shape[1:]
    args = [x.detach().contiguous() for x in (
        o, d, volumes.lo, volumes.hi, pack.padded, volumes.transfer)]
    if args[-1].data_ptr() % 16:
        args[-1] = args[-1].clone()   # read as float4
    args += [pack.bits, bg.detach().contiguous()]

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = trav._library().vsnray_volume_march(
            *[x.data_ptr() for x in args], color.data_ptr(), hit.data_ptr(),
            depth.data_ptr(), ptr(dst), ptr(steps), ptr(empty), ptr(warps),
            n, V, D, H, W, T, pack.brick.bit_length() - 1, nbx, nby, nbz,
            int(form == "shared"), float(step_scale), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: cudaError {err}")
    trav.LAUNCHES["volume_march"] += 1
    trav.ENTRY_LAUNCHES[ENTRY] += 1
    key = f"volume_march/transfer_{form}"
    trav.VARIANT_LAUNCHES[key] = trav.VARIANT_LAUNCHES.get(key, 0) + 1
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
                 steps=None, empty=None, warps=None):
    """(color (N, 4), hit (N,), depth (N,)) of lanes ``o``, ``d`` (N, 3)
    f32.  CUDA tensors launch the kernel, and its backward kernel where
    rays, boxes, texels, transfer or bg require grad; CPU tensors run
    ``march_plain``.  The kernel's counting form: ``steps``, an (N,)
    int32 tensor it fills with each ray's steps taken; with it, optionally
    ``empty``, the same for the steps it skipped in empty bricks, and
    ``warps``, a (2,) int64 tensor it adds its warp-iterations and those
    whose every lane skipped to."""
    _check(o, d, volumes, bg)
    if o.device.type == "cpu":
        return march_plain(o, d, volumes, bg, step_scale)
    if o.device.type != "cuda":
        raise ValueError(f"volume_march: no kernel for {o.device}")
    for name, x, shape, dtype in (("steps", steps, (o.shape[0],),
                                   torch.int32),
                                  ("empty", empty, (o.shape[0],),
                                   torch.int32),
                                  ("warps", warps, (2,), torch.int64)):
        if x is not None and (tuple(x.shape) != shape or x.dtype != dtype
                              or x.device != o.device):
            raise ValueError(f"volume_march: {name} must be {dtype} "
                             f"{shape} on the rays' device")
    if steps is None and (empty is not None or warps is not None):
        raise ValueError("volume_march: empty and warps need steps (the "
                         "counting form)")
    inputs = (o, d, volumes.lo, volumes.hi, volumes.texels,
              volumes.transfer, bg)
    if not (torch.is_grad_enabled() and any(x.requires_grad
                                            for x in inputs)):
        return _launch(o, d, volumes, bg, step_scale, steps, empty=empty,
                       warps=warps)[:3]
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
