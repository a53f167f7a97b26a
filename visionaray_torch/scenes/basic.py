"""Basic procedural scenes (port of scenes/basic.py): the mixed-primitive
scene of config #1, the Cornell box and its spectral variant with the
measured SPDs, and a random triangle soup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.device import resolve_device
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading import spectrum as sp
from visionaray_torch.shading.materials import Materials


def tri_sphere_plane(device="cuda"):
    """Config #1: one triangle and a sphere on a ground plane.  Returns
    (scene, camera)."""
    dev = resolve_device(device)
    vertices = np.array([
        [-1.5, 0.0, -1.0],
        [-0.2, 0.0, -1.2],
        [-0.85, 1.6, -1.1],
    ], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    mesh = TriangleMesh.create(vertices, faces, geom_ids=[0], device=dev)
    spheres = Spheres.create(center=[[0.8, 0.6, 0.0]], radius=[0.6],
                             geom_ids=[1], device=dev)
    planes = Planes.create(normal=[[0.0, 1.0, 0.0]], offset=[0.0],
                           geom_ids=[2], device=dev)
    materials = Materials.concatenate([
        Materials.plastic(cd=(0.8, 0.2, 0.1), kd=1.0, cs=(0.2, 0.2, 0.2),
                          ks=1.0, specular_exp=32.0, ca=(0.2, 0.2, 0.2),
                          ka=1.0, device=dev),
        Materials.plastic(cd=(0.1, 0.7, 0.2), kd=1.0, cs=(0.5, 0.5, 0.5),
                          ks=1.0, specular_exp=64.0, ca=(0.2, 0.2, 0.2),
                          ka=1.0, device=dev),
        Materials.matte(cd=(0.6, 0.6, 0.6), kd=1.0, ca=(0.2, 0.2, 0.2),
                        ka=1.0, device=dev),
    ])
    lights = PointLights.create(position=[[2.0, 5.0, 3.0]],
                                cl=(1.0, 1.0, 1.0), kl=1.0, device=dev)
    scene = Scene.create(mesh=mesh, spheres=spheres, planes=planes,
                         materials=materials, lights=lights, device=dev)
    cam = Pinhole.create(eye=(0.0, 1.5, 4.0), center=(0.0, 0.8, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=np.deg2rad(45.0),
                         aspect=1.0, device=dev)
    return scene, cam


def _box(lo, hi):
    """The six quads of an axis-aligned box, each as 4 corners."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    return [
        ([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),   # -z
        ([x0, y0, z1], [x0, y1, z1], [x1, y1, z1], [x1, y0, z1]),   # +z
        ([x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1]),   # -x
        ([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),   # +x
        ([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),   # +y
        ([x0, y0, z0], [x0, y0, z1], [x1, y0, z1], [x1, y0, z0]),   # -y
    ]


def cornell_box(light_scale: float = 1.0, device="cuda"):
    """Config #3: the Cornell box with an emissive area patch, the classic
    proportions scaled to [0, 5.55]^3.  Returns (scene, camera)."""
    dev = resolve_device(device)
    s = 5.55
    white, red, green, light = 0, 1, 2, 3
    quads = [   # (4 corners, material)
        (([0, 0, 0], [s, 0, 0], [s, 0, s], [0, 0, s]), white),   # floor
        (([0, s, 0], [0, s, s], [s, s, s], [s, s, 0]), white),   # ceiling
        (([0, 0, s], [s, 0, s], [s, s, s], [0, s, s]), white),   # back
        (([0, 0, 0], [0, 0, s], [0, s, s], [0, s, 0]), red),     # left
        (([s, 0, 0], [s, s, 0], [s, s, s], [s, 0, s]), green),   # right
    ]
    l0, l1, ly = 0.35 * s, 0.65 * s, s - 0.005 * s   # light patch
    quads.append((([l0, ly, l0], [l1, ly, l0], [l1, ly, l1], [l0, ly, l1]),
                  light))
    for f in _box((0.12 * s, 0.0, 0.10 * s), (0.42 * s, 0.30 * s, 0.40 * s)):
        quads.append((f, white))
    for f in _box((0.55 * s, 0.0, 0.45 * s), (0.85 * s, 0.60 * s, 0.75 * s)):
        quads.append((f, white))

    verts, faces, gids = [], [], []
    for corners, mat in quads:
        base = len(verts)
        verts.extend(corners)
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
        gids.extend([mat, mat])

    mesh = TriangleMesh.create(np.asarray(verts, np.float32),
                               np.asarray(faces, np.int32),
                               geom_ids=np.asarray(gids, np.int32),
                               device=dev)
    materials = Materials.concatenate([
        Materials.matte(cd=(0.73, 0.73, 0.73), kd=1.0, ca=(0, 0, 0), ka=0.0,
                        device=dev),
        Materials.matte(cd=(0.65, 0.05, 0.05), kd=1.0, ca=(0, 0, 0), ka=0.0,
                        device=dev),
        Materials.matte(cd=(0.12, 0.45, 0.15), kd=1.0, ca=(0, 0, 0), ka=0.0,
                        device=dev),
        Materials.emissive(ce=(1.0, 0.85, 0.6), ls=8.0 * light_scale,
                           device=dev),
    ])
    scene = Scene.create(mesh=mesh, materials=materials,
                         lights=PointLights.none(device=dev), device=dev)
    cam = Pinhole.create(eye=(0.5 * s, 0.5 * s, -1.45 * s),
                         center=(0.5 * s, 0.5 * s, 0.0),
                         up=(0.0, 1.0, 0.0),
                         fovy=np.deg2rad(40.0), aspect=1.0, device=dev)
    return scene, cam


def cornell_box_spectral(n_samples: int = 60, light_scale: float = 1.0,
                         device="cuda"):
    """The Cornell box with the measured wall and light SPDs (config #3's
    spectral variant; reference detail/spd/*): the RGB scene lifted to
    ``n_samples`` wavelengths, then the Cornell white, red and green
    reflectance curves and the lamp's SPD (normalized to a peak of 1)
    swapped in, which an RGB lift cannot express.  Render with
    algo="pathtracing"; the kernel folds back through the CIE observer.
    Returns (scene, camera)."""
    dev = resolve_device(device)
    scene, cam = cornell_box(light_scale=light_scale, device=dev)
    scene = sp.lift_scene(scene, n_samples)
    lam = sp.lambdas(n_samples, dev)
    cd = torch.stack([sp.cornell_white(lam), sp.cornell_red(lam),
                      sp.cornell_green(lam), torch.zeros_like(lam)])
    light_spd = sp.cornell_light(lam)
    light_spd = light_spd / torch.amax(light_spd)
    ce = torch.cat([torch.zeros((3, n_samples), dtype=torch.float32,
                                device=dev), light_spd[None]])
    mats = dataclasses.replace(scene.materials, cd=cd, ce=ce)
    return dataclasses.replace(scene, materials=mats), cam


def random_triangles(n: int, seed: int = 0, extent: float = 10.0,
                     tri_size: float = 0.35):
    """Deterministic random triangle soup as numpy (vertices (3n, 3),
    faces (n, 3)), for BVH-build and traversal stress tests."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n, 3), np.float32) - 0.5) * extent
    offs = (rng.random((n, 3, 3), np.float32) - 0.5) * tri_size
    verts = (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, faces
