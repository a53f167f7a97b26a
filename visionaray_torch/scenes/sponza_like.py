"""Sponza-class procedural scene (numpy copy of scenes/sponza_like.py).

A deterministic architectural atrium of the Crytek Sponza's scale: a
colonnaded courtyard (fluted columns, capitals, walls, tiled floor,
banners) topped up to ``target_tris`` with a tessellated dome.  At the
default 260,000 target it has 259,656 triangles.
"""

from __future__ import annotations

import numpy as np

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Scene, TriangleMesh
from visionaray_torch.device import resolve_device
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials


def _grid_quad(p00, p10, p01, res_u, res_v):
    """Subdivided parallelogram patch: origin p00 spanned by (p10-p00, p01-p00)."""
    p00 = np.asarray(p00, np.float32)
    du = (np.asarray(p10, np.float32) - p00) / res_u
    dv = (np.asarray(p01, np.float32) - p00) / res_v
    iu, iv = np.meshgrid(np.arange(res_u + 1), np.arange(res_v + 1),
                         indexing="ij")
    verts = (p00[None, None]
             + iu[..., None] * du[None, None]
             + iv[..., None] * dv[None, None]).reshape(-1, 3)
    faces = []
    for i in range(res_u):
        for j in range(res_v):
            a = i * (res_v + 1) + j
            b = a + 1
            c = a + (res_v + 1)
            d = c + 1
            faces.append([a, c, d])
            faces.append([a, d, b])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _fluted_column(center, radius, height, segments, rings, flutes=12,
                   flute_depth=0.08):
    cx, cz = center
    theta = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = radius * (1.0 - flute_depth * (0.5 + 0.5 * np.cos(flutes * theta)))
    ys = np.linspace(0.0, height, rings + 1)
    verts = []
    for y in ys:
        taper = 1.0 - 0.15 * (y / height)
        verts.append(np.stack([cx + r * taper * np.cos(theta),
                               np.full_like(theta, y),
                               cz + r * taper * np.sin(theta)], axis=-1))
    verts = np.concatenate(verts, axis=0).astype(np.float32)
    faces = []
    for i in range(rings):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c = (i + 1) * segments + j
            d = (i + 1) * segments + (j + 1) % segments
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int32)


def sponza_like_mesh(target_tris: int = 260_000, seed: int = 7):
    """Returns numpy (verts, faces, geom_ids) with len(faces) ~= target_tris."""
    rng = np.random.default_rng(seed)
    scale = max(0.05, min(4.0, target_tris / 260_000.0))
    col_seg = max(8, int(48 * np.sqrt(scale)))
    col_rings = max(4, int(40 * np.sqrt(scale)))
    floor_res = max(8, int(64 * np.sqrt(scale)))

    W, D, H = 24.0, 12.0, 10.0   # courtyard dims
    parts = []  # (verts, faces, gid)

    patches = [
        (( 0, 0,  0), ( W, 0, 0), (0, 0,  D), 0),              # floor
        (( 0, H,  0), ( W, H, 0), (0, H,  D), 1),              # ceiling
        (( 0, 0,  0), ( W, 0, 0), (0, H,  0), 1),              # back wall
        (( 0, 0,  D), ( W, 0, D), (0, H,  D), 1),              # front wall
        (( 0, 0,  0), ( 0, 0, D), (0, H,  0), 1),              # left wall
        (( W, 0,  0), ( W, 0, D), (W, H,  0), 1),              # right wall
    ]
    for p00, p10, p01, gid in patches:
        v, f = _grid_quad(p00, p10, p01, floor_res, floor_res // 2)
        parts.append((v, f, gid))

    n_cols = 8
    for i in range(n_cols):
        x = 2.0 + i * (W - 4.0) / (n_cols - 1)
        for z in (3.0, D - 3.0):
            v, f = _fluted_column((x, z), 0.5, H * 0.72,
                                  col_seg, col_rings)
            parts.append((v, f, 2))
            v2, f2 = _fluted_column((x, z), 0.75, H * 0.06,
                                    col_seg // 2, 3, flutes=4)
            v2 = v2 + np.array([0.0, H * 0.72, 0.0], np.float32)
            parts.append((v2, f2, 3))

    for i in range(6):
        x = 3.0 + i * (W - 6.0) / 5.0
        v, f = _grid_quad((x, H * 0.45, D * 0.35),
                          (x + 1.6, H * 0.45, D * 0.35),
                          (x, H * 0.8, D * 0.42),
                          floor_res // 2, floor_res // 2)
        v = v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        parts.append((v, f, 4))

    verts, faces, gids = [], [], []
    off = 0
    for v, f, g in parts:
        verts.append(v)
        faces.append(f + off)
        gids.append(np.full(len(f), g, np.int32))
        off += len(v)
    verts = np.concatenate(verts, axis=0)
    faces = np.concatenate(faces, axis=0)
    gids = np.concatenate(gids, axis=0)

    if len(faces) < target_tris:
        need = target_tris - len(faces)
        res = max(4, int(np.sqrt(need / 2)))
        v, f = _grid_quad((0, H, 0), (W, H, 0), (0, H, D), res,
                          max(2, need // (2 * res)))
        v[:, 1] += 0.5 * np.sin(v[:, 0] / W * np.pi) \
            * np.sin(v[:, 2] / D * np.pi)
        verts = np.concatenate([verts, v + np.array([0, 0.2, 0], np.float32)])
        faces = np.concatenate([faces, f[:need] + (len(verts) - len(v))])
        gids = np.concatenate([gids, np.full(min(need, len(f)), 1, np.int32)])

    return verts.astype(np.float32), faces.astype(np.int32), gids


def sponza_like_scene(target_tris: int = 260_000, build_bvh: bool = True,
                      seed: int = 7, device="cuda"):
    """Returns (scene, camera) for the sponza-class benchmark; with
    ``build_bvh`` the scene carries an LBVH (``ops.lbvh.build_lbvh``), as
    the JAX package's does.  Callers that attach a ClusterBVH pass
    ``build_bvh=False``."""
    dev = resolve_device(device)
    verts, faces, gids = sponza_like_mesh(target_tris, seed)
    mesh = TriangleMesh.create(verts, faces, geom_ids=gids, device=dev)
    materials = Materials.concatenate([
        Materials.plastic(cd=(0.55, 0.45, 0.35), kd=1.0, cs=(0.1, 0.1, 0.1),
                          ks=1.0, specular_exp=16.0, ca=(0.2, 0.2, 0.2),
                          ka=1.0, device=dev),
        Materials.matte(cd=(0.7, 0.65, 0.55), kd=1.0, device=dev),
        Materials.plastic(cd=(0.8, 0.75, 0.65), kd=1.0, cs=(0.3, 0.3, 0.3),
                          ks=1.0, specular_exp=32.0, ca=(0.2, 0.2, 0.2),
                          ka=1.0, device=dev),
        Materials.plastic(cd=(0.75, 0.7, 0.6), kd=1.0, cs=(0.2, 0.2, 0.2),
                          ks=1.0, specular_exp=8.0, ca=(0.2, 0.2, 0.2),
                          ka=1.0, device=dev),
        Materials.matte(cd=(0.6, 0.15, 0.1), kd=1.0, device=dev),
    ])
    lights = PointLights.create(position=[[12.0, 9.0, 6.0]],
                                cl=(1.0, 0.95, 0.9), kl=1.0, device=dev)
    scene = Scene.create(mesh=mesh, materials=materials, lights=lights,
                         device=dev)
    if build_bvh:
        from visionaray_torch.ops.lbvh import build_lbvh
        scene.bvh = build_lbvh(mesh)
    cam = Pinhole.create(eye=(2.5, 2.2, 6.0), center=(18.0, 4.0, 6.0),
                         up=(0.0, 1.0, 0.0), fovy=np.deg2rad(55.0),
                         aspect=16.0 / 9.0, device=dev)
    return scene, cam
