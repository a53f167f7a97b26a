"""The training step of bench.py: loss and gradients of one path-traced
frame with respect to the vertices and the albedo ``cd`` (port of
bench.py:123-140, ``jax.value_and_grad(loss_fn, argnums=(0, 1))``).

The loss is the mean of the rendered RGB over the frame's pixels,
``sum(color[..., :3]) / (n * 3)``.  As in bench.py the pixels are rendered
in tiles of ``tile`` lanes and the last tile is padded with pixel (0, 0):
those lanes are rendered and counted in the sum, and n stays the number of
pixels.  At 1920x1080 the one 2^21-lane tile carries 23,552 such lanes.

The gradient comes from ``kernels/pathtracing.py``'s bounces, each kept as
its carry and its walks' outputs (``ops/traverse.py``'s tape), so the
backward launches no walk.  Two paths: on a triangle scene on a flat
LBVH-tier tree with point lights, RGB and no textures or hit filter
(``_fused_ok``), each bounce's forward is the two hand shading kernels
around the walks (``_FusedBounce``: five hit-kernel launches a 5-bounce
step) and, on the card, its backward one launch of their adjoint kernel
(five a step; on the CPU, the recompute below); any other scene runs the
torch body's checkpointed bounces forward and recomputes them in the
backward with the walks replayed.  The loss is the same on both; the
gradients differ by the float32 rounding of each lane's chain rule and
the order the lanes' shares are summed into a leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from visionaray_torch.sched.render import render_pixels
from visionaray_torch.utils import metrics

WIDTH, HEIGHT, SPP = 1920, 1080, 1
TILE = 1 << 21     # bench.py TILE: lanes rendered per render_pixels call


def frame_loss(verts, cd, frame, params, cam, x, y, nee: bool = True, *,
               width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
               tile: int = TILE):
    """bench.py's loss of the frame at pixels (x, y), in that order; a
    tensor that autograd can differentiate in ``verts`` and ``cd``.  The
    mesh's stored face normals stay as they were (bench.py:124-127)."""
    scene = params.scene
    p2 = dataclasses.replace(params, scene=dataclasses.replace(
        scene, mesh=dataclasses.replace(scene.mesh, vertices=verts),
        materials=dataclasses.replace(scene.materials, cd=cd)))
    n = x.shape[0]
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    if pad:
        x = torch.cat([x, torch.zeros((pad,), dtype=x.dtype,
                                      device=x.device)])
        y = torch.cat([y, torch.zeros((pad,), dtype=y.dtype,
                                      device=y.device)])
    sums = []
    for i in range(n_tiles):
        sl = slice(i * tile, (i + 1) * tile)
        color, _ = render_pixels(p2, cam, x[sl], y[sl], width, height,
                                 "pathtracing", spp, "jittered_blend", frame,
                                 nee=nee)
        sums.append(torch.sum(color[..., :3]))
    return torch.sum(torch.stack(sums)) / (n * 3)


def loss_and_grads(verts, cd, frame, params, cam, x, y, nee: bool = True,
                   **kw):
    """``(loss, (g_verts, g_cd))`` of bench.py's step; ``kw`` as for
    ``frame_loss`` (width, height, spp, tile).  Spans (utils/metrics.py):
    ``step.forward`` around the loss, ``step.backward`` around the
    gradients (which hold the bounces' recompute)."""
    with torch.enable_grad():
        verts = verts.detach().requires_grad_()
        cd = cd.detach().requires_grad_()
        with metrics.span("step.forward"):
            loss = frame_loss(verts, cd, frame, params, cam, x, y, nee, **kw)
        with metrics.span("step.backward"):
            g_verts, g_cd = torch.autograd.grad(loss, (verts, cd))
    return loss.detach(), (g_verts, g_cd)
