#!/usr/bin/env python
"""Silhouette-driven shape optimization with the PyTorch port
(examples/silhouette_optimization.py's counterpart).

A triangle is rendered at a target pose, then recovered from a shifted
start by gradient descent on the pixel L2 loss.  At fixed hit topology
the gradient of which pixels the triangle covers is exactly zero: without
the boundary term the optimizer cannot move the silhouette (try
--no-boundary).  With ``diff.boundary.boundary_image`` in the loss the
silhouette's motion has a gradient (screen-space edge sampling) and the
triangle slides into place.

    python examples/torch_silhouette_optimization.py [--device cuda|cpu]
        [--steps 60] [--size 48]
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import argparse

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-boundary", action="store_true",
                    help="ablation: interior-only gradients (goes nowhere)")
    args = ap.parse_args()

    from visionaray_torch.core.camera import Pinhole
    from visionaray_torch.core.scene import Scene, TriangleMesh
    from visionaray_torch.diff.boundary import (
        boundary_image, build_edge_adjacency,
    )
    from visionaray_torch.io.image import save_png
    from visionaray_torch.kernels.params import KernelParams
    from visionaray_torch.sched.render import _render_frame
    from visionaray_torch.shading.lights import PointLights
    from visionaray_torch.shading.materials import Materials

    dev = args.device
    W = H = args.size
    faces = np.array([[0, 1, 2]], np.int32)
    target_v = torch.tensor([[-0.5, -0.4, 0.0], [0.6, -0.3, 0.0],
                             [0.05, 0.7, 0.0]], dtype=torch.float32,
                            device=dev)
    init_v = target_v + torch.tensor([0.35, -0.25, 0.0], device=dev)
    cam = Pinhole.create(eye=(0, 0, 3), center=(0, 0, 0),
                         fovy=np.deg2rad(45), aspect=1.0, device=dev)
    adj = build_edge_adjacency(faces, device=dev)
    mats = Materials.matte(cd=(0.85, 0.3, 0.2), device=dev)
    lights = PointLights.create(position=[[2, 3, 4]], device=dev)

    def make_params(v):
        mesh = TriangleMesh.create(v, faces, device=dev)
        return KernelParams.create(
            Scene.create(mesh=mesh, materials=mats, lights=lights,
                         device=dev),
            num_bounces=1, epsilon=1e-3, bg_color=(0.05, 0.1, 0.3, 1.0),
            ambient_color=(0.2, 0.2, 0.2, 1.0))

    def frame(v):
        p = make_params(v)
        color, _ = _render_frame(p, cam, W, H, "simple", 1, "uniform", 0,
                                 1, 0)
        if not args.no_boundary:
            color = color + boundary_image(p, cam, W, H, adj, algo="simple",
                                           vertices=v, samples_per_edge=16)
        return color

    with torch.no_grad():
        target = frame(target_v)

    v = init_v.clone()
    m = torch.zeros_like(v)
    u = torch.zeros_like(v)
    loss0 = None
    for i in range(args.steps):
        vv = v.clone().requires_grad_()
        loss = torch.mean((frame(vv)[..., :3] - target[..., :3]) ** 2)
        (g,) = torch.autograd.grad(loss, (vv,))
        loss = loss.detach()
        # Adam: the boundary gradient shrinks as the overlap grows (only
        # the silhouette ring contributes), so a normalized step converges
        # where plain SGD crawls
        m = 0.9 * m + 0.1 * g
        u = 0.999 * u + 0.001 * g * g
        mh = m / (1.0 - 0.9 ** (i + 1))
        uh = u / (1.0 - 0.999 ** (i + 1))
        v = v - args.lr * mh / (torch.sqrt(uh) + 1e-8)
        if loss0 is None:
            loss0 = float(loss)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.6f}  "
                  f"|v - target| {float((v - target_v).abs().max()):.4f}",
                  flush=True)

    with torch.no_grad():
        save_png("silhouette_before.png", frame(init_v).cpu().numpy()[..., :3])
        save_png("silhouette_after.png", frame(v).cpu().numpy()[..., :3])
    print(f"wrote silhouette_before.png silhouette_after.png  "
          f"loss {loss0:.6f} -> {float(loss):.6f}")
    # |v - target| need not reach 0: a pinhole camera cannot see the
    # depth/scale ambiguity, only the image loss is constrained
    if args.no_boundary:
        print("(interior-only ablation: the silhouette cannot move)")


if __name__ == "__main__":
    main()
