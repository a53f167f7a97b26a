"""The volume march of kernels/volume.py::march_plain taken step by step,
for the tests of the march kernel's empty-brick skip (torch only, so
that the CUDA tests can use it where the JAX package is not installed).

``march_steps`` runs march_plain's arithmetic in its order, every rank's
512 masked steps, and for each live step also finds what the kernel
(ops/cuda/volume_common.cuh fast_step) decides: the step's base cell,
each axis clamped into the grid and shifted down by log2 B, names a
brick; the kernel skips the step when the brick table marks it empty,
the base cell lies within 2^30 on every axis and the box's dt is finite
and >= 0.  It counts the live steps and the skipped ones, and the
skipped steps that would have changed the colour (an opacity other than
exactly 0, or a colour that is not finite): the skip is exact only where
there are none.  With ``skip=True`` the composite leaves out the skipped
steps, as the kernel does.
"""

import torch

from visionaray_torch.kernels import volume as tvol

FLT_MAX = 3.4028234663852886e38
XT_LIMIT = 2.0 ** 30


def kernel_skips(table, brick, vi, uvw, dims, dt):
    """The kernel's decision for one step of every lane: (N,) bool."""
    D, H, W = dims
    shift = brick.bit_length() - 1
    x = uvw[:, 0] * W - 0.5
    y = uvw[:, 1] * H - 0.5
    z = uvw[:, 2] * D - 0.5
    fits = (x.abs() < XT_LIMIT) & (y.abs() < XT_LIMIT) & (z.abs() < XT_LIMIT)

    def cell(c, n):
        c0 = torch.floor(torch.where(fits, c, 0.0)).to(torch.int64)
        return torch.clamp(c0, 0, n - 1) >> shift

    hit = table[vi.long(), cell(z, D), cell(y, H), cell(x, W)]
    return hit & fits & (dt >= 0) & (dt <= FLT_MAX)


def march_steps(o, d, volumes, bg, step_scale=1.0, brick=tvol.BRICK,
                skip=False, table=None):
    """A dict: ``color``, ``hit``, ``depth`` and ``dst`` (the composite
    before the background) of the march, ``steps`` and ``empty`` (N,) the
    live steps and those the kernel skips, ``changed`` the number of
    skipped steps whose opacity is not exactly 0 or whose colour is not
    finite.  ``table``: the brick table, ``tvol.brick_table``'s by
    default."""
    lo, hi = volumes.lo, volumes.hi
    texels, transfer = volumes.texels, volumes.transfer
    if table is None:
        table = tvol.brick_table(texels, transfer, brick)
    V = lo.shape[0]
    n = o.shape[0]
    dst = torch.zeros((n, 4), dtype=torch.float32, device=o.device)
    steps = torch.zeros(n, dtype=torch.int64, device=o.device)
    empty = torch.zeros(n, dtype=torch.int64, device=o.device)
    changed = 0
    tn_all, tf_all, hit_all, any_hit, depth = tvol._entries(o, d, lo, hi)
    inf = torch.full_like(tn_all, float("inf"))
    order = torch.argsort(torch.where(hit_all, tn_all, inf), dim=0,
                          stable=True)
    D3 = torch.tensor(texels.shape[1:4], dtype=torch.float32,
                      device=o.device)
    dims = tuple(texels.shape[1:4])
    zero = torch.zeros((), dtype=torch.float32, device=o.device)
    one = torch.ones((), dtype=torch.float32, device=o.device)
    for r in range(V):
        vi = order[r]
        lo_v = lo[vi]
        extent = hi[vi] - lo_v
        tn = torch.gather(tn_all, 0, vi[None])[0]
        tf = torch.gather(tf_all, 0, vi[None])[0]
        inside = torch.gather(hit_all, 0, vi[None])[0]
        dt = step_scale * torch.amin(extent / D3, dim=-1)
        for i in range(tvol.MAX_STEPS):
            t = tn + dt * i
            live = inside & (t < tf) & (dst[:, 3] < 0.999)
            p = o + d * t[:, None]
            uvw = (p - lo_v) / extent
            s = tvol._tex3d_multi(texels, vi, uvw[:, 0], uvw[:, 1],
                                  uvw[:, 2])
            c = tvol._tex1d_multi(transfer, vi, s)
            a = torch.minimum(torch.maximum(c[:, 3] * dt * D3[0], zero), one)
            contrib = torch.cat([c[:, :3] * a[:, None], a[:, None]], dim=-1)
            new_dst = dst + (1.0 - dst[:, 3:4]) * contrib
            skipped = live & kernel_skips(table, brick, vi, uvw, dims, dt)
            steps += live.long()
            empty += skipped.long()
            changed += int((skipped & ((a != 0)
                                       | ~torch.isfinite(c[:, :3]).all(-1)))
                           .sum())
            take = live & ~skipped if skip else live
            dst = torch.where(take[:, None], new_dst, dst)
    color = dst + (1.0 - dst[:, 3:4]) * bg
    return dict(color=color, hit=any_hit, depth=depth, dst=dst, steps=steps,
                empty=empty, changed=changed)
