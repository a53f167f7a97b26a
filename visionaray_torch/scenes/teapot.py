"""Procedural teapot (port of scenes/teapot.py: the mesh a numpy copy,
the scene and its LBVH built on ``device``; config #2 stand-in for the
Utah teapot .obj).

The environment has no network egress so the canonical teapot asset cannot be
fetched; this generates a teapot-shaped object procedurally: a lathed body +
lid from a profile curve, a swept-tube handle, and a tapered-tube spout.
Role in the config ladder (512x512 Whitted with shadows + 1 reflective
bounce over a few-thousand-triangle BVH) is preserved.  `io/obj.py` loads
real .obj teapots when the user supplies one.
"""

from __future__ import annotations

import numpy as np

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Planes, Scene, TriangleMesh
from visionaray_torch.device import resolve_device
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials


def _lathe(profile_r, profile_y, segments: int):
    """Surface of revolution around the y axis. Returns (verts, faces)."""
    n = len(profile_r)
    theta = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    verts = []
    for r, y in zip(profile_r, profile_y):
        verts.append(np.stack([r * np.cos(theta), np.full_like(theta, y),
                               r * np.sin(theta)], axis=-1))
    verts = np.concatenate(verts, axis=0).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c = (i + 1) * segments + j
            d = (i + 1) * segments + (j + 1) % segments
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int32)


def _tube(path, radii, segments: int):
    """Sweep a circle along a 3D path. Returns (verts, faces)."""
    path = np.asarray(path, np.float32)
    n = len(path)
    # parallel-transport-ish frames
    tangents = np.gradient(path, axis=0)
    tangents /= np.linalg.norm(tangents, axis=-1, keepdims=True) + 1e-12
    up = np.array([0.0, 1.0, 0.0], np.float32)
    verts = []
    for i in range(n):
        t = tangents[i]
        side = np.cross(up, t)
        if np.linalg.norm(side) < 1e-6:
            side = np.array([1.0, 0.0, 0.0], np.float32)
        side /= np.linalg.norm(side)
        nrm = np.cross(t, side)
        theta = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
        ring = (path[i][None, :]
                + radii[i] * (np.cos(theta)[:, None] * side[None, :]
                              + np.sin(theta)[:, None] * nrm[None, :]))
        verts.append(ring)
    verts = np.concatenate(verts, axis=0).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c = (i + 1) * segments + j
            d = (i + 1) * segments + (j + 1) % segments
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int32)


def teapot_mesh(detail: int = 24):
    """Generate the teapot triangle soup. detail=24 -> ~6.5k triangles."""
    seg = detail
    # body profile (radius, height)
    t = np.linspace(0.0, 1.0, detail)
    body_r = 0.25 + 1.15 * np.sin(np.pi * (0.08 + 0.84 * t)) ** 1.2
    body_y = 2.2 * t
    body_v, body_f = _lathe(body_r, body_y, seg)
    # lid profile
    tl = np.linspace(0.0, 1.0, max(6, detail // 3))
    lid_r = 0.95 * (1.0 - tl ** 1.5) + 0.001
    lid_y = 2.2 + 0.55 * tl
    lid_v, lid_f = _lathe(lid_r, lid_y, seg)
    # knob
    tk = np.linspace(0.0, 1.0, 6)
    knob_r = 0.16 * np.sin(np.pi * tk) + 0.02
    knob_y = 2.75 + 0.28 * tk
    knob_v, knob_f = _lathe(knob_r, knob_y, seg)
    # spout: curve from body outward/up
    ts = np.linspace(0.0, 1.0, max(8, detail // 2))
    spout_path = np.stack([
        1.0 + 1.15 * ts,
        0.9 + 1.1 * ts ** 1.4,
        np.zeros_like(ts),
    ], axis=-1)
    spout_r = 0.30 * (1.0 - 0.55 * ts)
    spout_v, spout_f = _tube(spout_path, spout_r, max(8, seg // 2))
    # handle: arc on the -x side
    th = np.linspace(0.0, np.pi, max(10, detail // 2))
    handle_path = np.stack([
        -0.95 - 0.75 * np.sin(th),
        1.55 + 0.72 * np.cos(th),
        np.zeros_like(th),
    ], axis=-1)
    handle_r = np.full_like(th, 0.10)
    handle_v, handle_f = _tube(handle_path, handle_r, max(8, seg // 2))

    parts = [(body_v, body_f), (lid_v, lid_f), (knob_v, knob_f),
             (spout_v, spout_f), (handle_v, handle_f)]
    verts, faces = [], []
    off = 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return (np.concatenate(verts, axis=0),
            np.concatenate(faces, axis=0))


def teapot_scene(detail: int = 24, build_bvh: bool = True, device="cuda"):
    """BASELINE config #2: teapot over a ground plane, one point light;
    with ``build_bvh`` an LBVH over the teapot, built on ``device``.

    Returns (scene, camera).
    """
    dev = resolve_device(device)
    verts, faces = teapot_mesh(detail)
    mesh = TriangleMesh.create(verts, faces,
                               geom_ids=np.zeros(len(faces), np.int32),
                               device=dev)
    planes = Planes.create(normal=[[0.0, 1.0, 0.0]], offset=[0.0],
                           geom_ids=[1], device=dev)
    materials = Materials.concatenate([
        Materials.plastic(cd=(0.7, 0.5, 0.2), kd=1.0, cs=(0.4, 0.4, 0.4),
                          ks=1.0, specular_exp=48.0, ca=(0.2, 0.15, 0.1),
                          ka=1.0, device=dev),
        Materials.mirror(cr=(0.9, 0.9, 0.9), kr=0.8, device=dev),
    ])
    lights = PointLights.create(position=[[4.0, 6.0, 5.0]],
                                cl=(1.0, 1.0, 1.0), kl=1.0, device=dev)
    scene = Scene.create(mesh=mesh, planes=planes, materials=materials,
                         lights=lights, device=dev)
    if build_bvh:
        from visionaray_torch.ops.lbvh import build_lbvh
        scene.bvh = build_lbvh(mesh)
    cam = Pinhole.create(eye=(5.2, 3.6, 6.2), center=(0.0, 1.3, 0.0),
                         up=(0.0, 1.0, 0.0), fovy=np.deg2rad(45.0),
                         aspect=1.0, device=dev)
    return scene, cam
