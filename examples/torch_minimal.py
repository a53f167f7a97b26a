#!/usr/bin/env python
"""Minimal library usage of the PyTorch port (examples/minimal.py's
counterpart): a Pinhole, a RenderTarget, the scheduler inside
``render()``, KernelParams and a custom kernel, a function returning
white where the ray hits, registered under a name.

    python examples/torch_minimal.py [--device cuda|cpu]
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import argparse

import numpy as np
import torch

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Scene, TriangleMesh
from visionaray_torch.core.types import ResultRecord
from visionaray_torch.io.image import save_png
from visionaray_torch.ops.trace import closest_hit
from visionaray_torch.sched.render import KERNELS, render


def white_kernel(params, ray, sampler=None):
    hr = closest_hit(ray, params.scene)
    white = torch.ones(tuple(hr.t.shape) + (4,), dtype=torch.float32,
                       device=hr.t.device)
    color = torch.where(hr.hit[..., None], white, params.bg_color)
    return ResultRecord(color=color, hit=hr.hit, depth=hr.t)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    KERNELS["white"] = white_kernel

    # one triangle
    mesh = TriangleMesh.create(
        np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32), device=args.device)
    scene = Scene.create(mesh=mesh, device=args.device)
    cam = Pinhole.create(eye=(0, 0, 3), center=(0, 0, 0),
                         fovy=np.deg2rad(45), aspect=1.0, device=args.device)
    rt = render(scene, cam, 128, 128, algo="white",
                bg_color=(0.1, 0.1, 0.3, 1.0))
    out = save_png("minimal.png", rt.color.cpu().numpy()[..., :3])
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
