#!/usr/bin/env python
"""Inverse rendering with the PyTorch port: recover the Cornell box's
albedos from a target image (examples/inverse_rendering.py's
counterpart).

Render, L2 loss against the target, gradients with respect to the
materials' albedo ``cd`` and emission ``ls``, momentum updates (SGD with
momentum 0.9, the JAX example's rule), the optimizer state checkpointed
with ``OptimCheckpoint`` so that a preempted run resumes.  ``--devices N``
splits the pixels over N ranks (parallel/tile_sharding.py): started
alone, the script runs itself as N local ranks; each rank's gradient is
its share of the frame's, and ``all_reduce_grads`` sums them.

    python examples/torch_inverse_rendering.py [--device cuda|cpu]
        [--devices N] [--steps 50] [--size 32]
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import argparse
import dataclasses
import os

import torch


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", default="inverse_ckpt.npz")
    p.add_argument("--resume", action="store_true")
    args = p.parse_args()

    from visionaray_torch.parallel import multihost
    if args.devices > 1 and "WORLD_SIZE" not in os.environ:
        return int(any(multihost.spawn_local(args.devices)))
    if args.devices > 1:
        multihost.initialize(device=args.device, backend=(
            multihost.local_backend(args.devices, args.device)))
    try:
        return run(args)
    finally:
        multihost.shutdown()


def run(args):
    """The optimization on this rank (its share of the pixels)."""
    from visionaray_torch.kernels.params import KernelParams
    from visionaray_torch.parallel.tile_sharding import (
        all_reduce_grads, make_mesh, render_image_sharded,
    )
    from visionaray_torch.scenes import cornell_box
    from visionaray_torch.utils.checkpoint import OptimCheckpoint

    dev = args.device
    if dev == "cuda" and torch.cuda.device_count():
        dev = f"cuda:{torch.cuda.current_device()}"
    scene, cam = cornell_box(device=dev)
    W = H = args.size
    mesh = make_mesh(args.devices)
    lead = mesh.rank == 0
    base = KernelParams.create(scene, num_bounces=args.bounces, epsilon=1e-3,
                               bg_color=(0, 0, 0, 1),
                               ambient_color=(0, 0, 0, 0))

    def render_theta(theta, frame):
        mats = dataclasses.replace(base.scene.materials, cd=theta["cd"],
                                   ls=theta["ls"])
        p2 = dataclasses.replace(
            base, scene=dataclasses.replace(base.scene, materials=mats))
        color, _ = render_image_sharded(
            p2, cam, W, H, mesh, algo="pathtracing", spp=1,
            pixel_sampler="jittered_blend", frame_num=frame)
        return color[..., :3]

    # ground truth: the true scene
    true_theta = {"cd": scene.materials.cd, "ls": scene.materials.ls}
    with torch.no_grad():
        target = render_theta(true_theta, 9999)

    # start from wrong albedos
    theta = {"cd": torch.clip(scene.materials.cd * 0.3 + 0.3, 0.05, 0.95),
             "ls": scene.materials.ls * 0.5}
    theta = {k: v.clone().requires_grad_() for k, v in theta.items()}
    opt = torch.optim.SGD(list(theta.values()), lr=args.lr, momentum=0.9)
    step0 = 0
    if args.resume:
        for v in theta.values():   # a state for every parameter to load into
            opt.state[v]["momentum_buffer"] = torch.zeros_like(v)
        loaded, state, step0 = OptimCheckpoint.load(
            args.checkpoint, {k: v.detach() for k, v in theta.items()},
            opt.state_dict())
        with torch.no_grad():
            for k, v in theta.items():
                v.copy_(loaded[k])
        opt.load_state_dict(state)
        if lead:
            print(f"resumed at step {step0}")

    for step in range(step0, args.steps):
        opt.zero_grad()
        loss = torch.mean((render_theta(theta, step + 1) - target) ** 2)
        loss.backward()
        all_reduce_grads(list(theta.values()), mesh)
        opt.step()
        with torch.no_grad():
            for v in theta.values():
                v.clamp_(0.0, 20.0)
        if step % 10 == 0 or step == args.steps - 1:
            err = float((theta["cd"].detach() - true_theta["cd"]).abs().mean())
            if lead:
                print(f"step {step:4d}  loss {float(loss):.6f}  "
                      f"albedo L1 {err:.4f}", flush=True)
                OptimCheckpoint.save(args.checkpoint,
                                     {k: v.detach()
                                      for k, v in theta.items()},
                                     opt.state_dict(), step + 1)

    err = float((theta["cd"].detach() - true_theta["cd"]).abs().mean())
    if lead:
        print(f"final albedo L1 error: {err:.4f} (started ~0.3)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
