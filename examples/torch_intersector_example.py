#!/usr/bin/env python
"""Custom intersector hook of the PyTorch port: alpha-mask transparency
(examples/intersector_example.py's counterpart; reference
examples/intersector).

The hook is a ``hit_filter(prim_id, t, u, v, hit) -> hit`` callable
passed to closest_hit: it samples a checkerboard alpha mask at the hit's
barycentric (u, v) and drops transparent candidates, so rays see through
the holes to the geometry behind.

    python examples/torch_intersector_example.py [--device cuda|cpu]
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import argparse

import numpy as np
import torch

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Planes, Scene, TriangleMesh
from visionaray_torch.core.types import ResultRecord
from visionaray_torch.core.vecmath import faceforward, normalize
from visionaray_torch.io.image import save_png
from visionaray_torch.ops.trace import closest_hit
from visionaray_torch.sched.render import KERNELS, render
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials
from visionaray_torch.shading.surface import get_surface


def checker_alpha(u, v, squares=8):
    """Checkerboard alpha mask: half the squares are transparent."""
    iu = torch.floor(u * squares).to(torch.int32)
    iv = torch.floor(v * squares).to(torch.int32)
    return ((iu + iv) % 2) == 0


def make_masked_kernel(scene):
    n_tris = scene.num_triangles

    def hit_filter(prim_id, t, u, v, hit):
        # only the quad's triangles (ids < n_tris) are alpha-masked
        masked = prim_id < n_tris
        return hit & (~masked | checker_alpha(u, v))

    def kernel(params, ray, sampler=None):
        hr = closest_hit(ray, params.scene, hit_filter=hit_filter)
        surf = get_surface(hr, ray, params.scene)
        view_dir = -ray.dir
        n = faceforward(surf.shading_normal, view_dir, surf.geometric_normal)
        isect = ray.at(torch.where(hr.hit, hr.t, 1.0))
        lights = params.scene.lights
        shaded = torch.zeros(tuple(hr.t.shape) + (3,), dtype=torch.float32,
                             device=hr.t.device)
        for li in range(lights.num_lights):
            ldir = normalize(lights.position[li] - isect)
            inten = lights.intensity(li, isect)
            shaded = shaded + surf.materials.shade(n, view_dir, ldir, inten)
        rgba = torch.cat([shaded, torch.ones_like(shaded[..., :1])], -1)
        color = torch.where(hr.hit[..., None], rgba, params.bg_color)
        return ResultRecord(color=color, hit=hr.hit, depth=hr.t)

    return kernel


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = args.device
    verts = np.array([[-1.5, 0.1, 0], [1.5, 0.1, 0], [1.5, 2.5, 0],
                      [-1.5, 2.5, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mesh = TriangleMesh.create(verts, faces, geom_ids=[0, 0], device=dev)
    planes = Planes.create(normal=[[0, 1, 0]], offset=[0.0], geom_ids=[1],
                           device=dev)
    mats = Materials.concatenate([
        Materials.plastic(cd=(0.8, 0.3, 0.2), device=dev),
        Materials.matte(cd=(0.5, 0.55, 0.6), device=dev),
    ])
    scene = Scene.create(mesh=mesh, planes=planes, materials=mats,
                         lights=PointLights.create(position=[[3, 5, 4]],
                                                   device=dev), device=dev)
    KERNELS["alpha_masked"] = make_masked_kernel(scene)
    cam = Pinhole.create(eye=(0.5, 1.8, 5.0), center=(0, 1.2, 0),
                         fovy=np.deg2rad(45), aspect=1.0, device=dev)
    rt = render(scene, cam, 256, 256, algo="alpha_masked",
                bg_color=(0.3, 0.5, 0.8, 1.0))
    print("wrote", save_png("intersector.png",
                            rt.color.cpu().numpy()[..., :3]))


if __name__ == "__main__":
    main()
