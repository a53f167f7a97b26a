"""Tile sharding: data-parallel rendering over ranks (port of
parallel/tile_sharding.py).

The flat pixel array is split into equal contiguous blocks, one per rank,
with the scene and its tree replicated; each rank renders its block with
``render_pixels`` and the blocks are gathered.  The counter-based RNG is
keyed by absolute pixel id, so the frame equals the single-process frame
for any number of ranks.

Gradients: ``shard_map`` inserts the ``psum`` of the replicated scene's
gradients over the mesh; here ``all_reduce_grads`` is that sum, called by
the user after ``backward()``.  The gathered frame's other blocks carry no
graph, so a loss over the whole frame (a mean, say) differentiates on
each rank into that rank's share of the gradient: the ranks' shares sum
to the gradient of the whole loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.parallel.comm import (
    TILE_AXIS, Mesh, all_gather, all_reduce_, world_mesh,
)
from visionaray_torch.sched.render import _pixel_grid, render_pixels

def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over every rank of the default group (``n_devices`` None
    or the world size), or a mesh of this rank alone (``n_devices`` 1),
    which never communicates."""
    world = world_mesh()
    if n_devices is None or n_devices == world.size:
        return world
    if n_devices == 1:
        return Mesh()
    raise ValueError(f"make_mesh: {n_devices} devices of {world.size} "
                     f"ranks; the port's meshes are all ranks or one")


def pad_to_multiple(x, m: int, axis: int = 0):
    """``x`` padded with zeros along ``axis`` to a multiple of ``m``."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype,
                                     device=x.device)], dim=axis)


def render_image_sharded(params: KernelParams, cam, width: int, height: int,
                         mesh: Mesh, algo: str = "pathtracing", spp: int = 1,
                         pixel_sampler: str = "jittered_blend",
                         frame_num=1, seed: int = 0, nee: bool = False,
                         tile_size: int = 0):
    """Render a full frame with the pixels split over ``mesh``'s ranks;
    every rank returns the whole (color (H, W, 4), depth (H, W)).

    The scene and tree are replicated on each rank's device (geometry
    sharding is parallel/ring.py).  ``tile_size``: each rank renders its
    block in sub-tiles of that many pixels, one after another, to bound
    live memory (JAX's lax.map)."""
    n_dev = mesh.size
    x, y = _pixel_grid(width, height, params.scene.device)
    chunk = n_dev * tile_size if tile_size else n_dev
    xf = pad_to_multiple(x, chunk)
    yf = pad_to_multiple(y, chunk)
    per = xf.shape[0] // n_dev
    xs = xf[mesh.rank * per:(mesh.rank + 1) * per]
    ys = yf[mesh.rank * per:(mesh.rank + 1) * per]
    if tile_size and per > tile_size:
        parts = [render_pixels(params, cam, xs[i:i + tile_size],
                               ys[i:i + tile_size], width, height, algo,
                               spp, pixel_sampler, frame_num, seed, nee=nee)
                 for i in range(0, per, tile_size)]
        col = torch.cat([p[0] for p in parts])
        dep = torch.cat([p[1] for p in parts])
    else:
        col, dep = render_pixels(params, cam, xs, ys, width, height, algo,
                                 spp, pixel_sampler, frame_num, seed,
                                 nee=nee)
    color = all_gather(col, mesh)
    depth = all_gather(dep, mesh)
    n = width * height
    return (color[:n].reshape(height, width, 4),
            depth[:n].reshape(height, width))


def all_reduce_grads(leaves, mesh: Mesh):
    """Sum the ``.grad`` of each replicated leaf over the ranks, in place
    (the psum that shard_map's transpose inserts).  A leaf that got no
    gradient on this rank takes zeros, so every rank reduces every leaf."""
    for leaf in leaves:
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        all_reduce_(leaf.grad, mesh)
    return leaves
