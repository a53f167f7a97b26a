#!/usr/bin/env python
"""Multi-hit transparency compositing with the PyTorch port
(examples/multi_hit_example.py's counterpart; reference
examples/multi_hit): multi_hit(k=8) and a front-to-back blend of every
hit along the ray.

    python examples/torch_multi_hit_example.py [--device cuda|cpu]
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import argparse

import numpy as np
import torch

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Scene, TriangleMesh
from visionaray_torch.core.types import ResultRecord
from visionaray_torch.device import take
from visionaray_torch.io.image import save_png
from visionaray_torch.ops.trace import multi_hit
from visionaray_torch.sched.render import KERNELS, render
from visionaray_torch.shading.materials import Materials

ALPHA = 0.35


def transparency_kernel(params, ray, sampler=None):
    rec = multi_hit(ray, params.scene, k=8)
    # per-hit colours from the materials' diffuse colour
    cd = take(params.scene.materials.cd, rec.geom_id)
    dst = torch.zeros(ray.batch_shape + (4,), dtype=torch.float32,
                      device=rec.t.device)
    for k in range(rec.t.shape[-1]):   # hits are sorted near to far
        a = torch.where(rec.hit[..., k], ALPHA, 0.0)[..., None]
        contrib = torch.cat([cd[..., k, :] * a, a], dim=-1)
        dst = dst + (1.0 - dst[..., 3:4]) * contrib
    color = dst + (1.0 - dst[..., 3:4]) * params.bg_color
    return ResultRecord(color=color, hit=rec.hit.any(dim=-1),
                        depth=rec.t[..., 0])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = args.device
    KERNELS["transparency"] = transparency_kernel
    verts, faces, gids = [], [], []
    for i, z in enumerate(np.linspace(0.0, 2.0, 5)):
        b = len(verts)
        s = 1.0 - 0.12 * i
        verts += [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
        faces += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        gids += [i, i]
    mesh = TriangleMesh.create(np.asarray(verts, np.float32),
                               np.asarray(faces, np.int32),
                               geom_ids=np.asarray(gids, np.int32),
                               device=dev)
    colors = [(0.9, 0.2, 0.2), (0.9, 0.7, 0.1), (0.2, 0.8, 0.3),
              (0.2, 0.5, 0.9), (0.7, 0.3, 0.8)]
    mats = Materials.concatenate([Materials.matte(cd=c, device=dev)
                                  for c in colors])
    scene = Scene.create(mesh=mesh, materials=mats, device=dev)
    cam = Pinhole.create(eye=(0.8, 0.9, 5.0), center=(0, 0, 1.0),
                         fovy=np.deg2rad(45), aspect=1.0, device=dev)
    rt = render(scene, cam, 256, 256, algo="transparency",
                bg_color=(0.05, 0.05, 0.1, 1.0))
    print("wrote", save_png("multi_hit.png", rt.color.cpu().numpy()[..., :3]))


if __name__ == "__main__":
    main()
