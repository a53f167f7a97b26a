#!/usr/bin/env python
"""Config #5 in miniature with the PyTorch port: geometry-sharded and
tile-sharded path tracing (examples/sharded_render.py's counterpart).

Each rank owns 1/D of the instanced scene (a morton-compact soup slice
and its own LBVH); the rays visit every shard round a ring of hops that
carries the running closest hit and its surface data home
(parallel/ring.py, parallel/sharded_pt.py).  Started alone, the script
runs itself as ``--devices`` local ranks (gloo on the CPU; on the card,
NCCL when every rank has a card of its own, else gloo, which stages the
hops through host buffers).

    python examples/torch_sharded_render.py [--device cuda|cpu]
        [--devices 2]
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import argparse
import os

import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", type=int, default=2)
    args = p.parse_args()

    from visionaray_torch.parallel import multihost
    if args.devices > 1 and "WORLD_SIZE" not in os.environ:
        return int(any(multihost.spawn_local(args.devices)))
    multihost.initialize(device=args.device, backend=(
        multihost.local_backend(args.devices, args.device)))
    try:
        return run(args)
    finally:
        multihost.shutdown()


def run(args):
    """One rank's share of the frame; rank 0 writes the image."""
    from visionaray_torch.io.image import save_png
    from visionaray_torch.parallel.ring import shard_geometry
    from visionaray_torch.parallel.sharded_pt import (
        render_image_geometry_sharded,
    )
    from visionaray_torch.parallel.tile_sharding import make_mesh
    from visionaray_torch.scenes import sponza_x16_scene

    mesh = make_mesh()
    n_dev = mesh.size
    dev = args.device
    if dev == "cuda":
        dev = f"cuda:{torch.cuda.current_device()}"
    scene, cam = sponza_x16_scene(target_tris_per_instance=2000,
                                  instances=16, device=dev)
    F = scene.num_triangles
    if mesh.rank == 0:
        print(f"{F} triangles over {n_dev} devices (~{F // n_dev} per "
              f"shard)", flush=True)
    geo = shard_geometry(scene.mesh, n_dev, backend="lbvh",
                         with_shading=True, shards=(mesh.rank,))
    color, depth = render_image_geometry_sharded(
        geo, scene.materials, scene.lights, cam, 160, 90, mesh,
        num_bounces=3, spp=1, nee=True, bg_color=(0.2, 0.3, 0.5, 1.0),
        ambient=(1.0, 1.0, 1.0))
    if mesh.rank == 0:
        save_png("sharded_render.png", color.cpu().numpy()[..., :3],
                 srgb=True)
        print("wrote sharded_render.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
