"""Instanced scene builders (port of scenes/instanced.py) — BASELINE
config #5 (Sponza x16).

The reference has no instancing; its viewer loads one model.  Config #5's
"instanced Sponza x16" asks for a scene 16x the sponza-class courtyard.
Instancing is applied at construction time (transforms baked into the
vertex buffer, on the host in numpy, as the JAX package does): the
renderer needs no run-time instance indirection.  Like JAX's, the scene
carries no BVH: the caller picks and builds the tree (the CLI's ``--bvh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.device import resolve_device, to_numpy
from visionaray_torch.scenes.sponza_like import sponza_like_scene



def instance_mesh(mesh: TriangleMesh, transforms) -> TriangleMesh:
    """Concatenate copies of ``mesh`` under 4x4 affine transforms, on the
    mesh's device.

    ``transforms``: (I, 4, 4) row-major affine matrices (applied as
    p' = M[:3,:3] @ p + M[:3,3]).  Normals are transformed with the
    inverse-transpose and re-normalized; geom_ids are preserved (instances
    share the material table).
    """
    M = np.asarray(transforms, np.float32)
    I = M.shape[0]
    verts, faces, gid = (to_numpy(x) for x in (mesh.vertices, mesh.faces,
                                               mesh.geom_ids))
    cn, tc = to_numpy(mesh.corner_normals), to_numpy(mesh.tex_coords)
    V = verts.shape[0]
    out_v, out_f, out_cn = [], [], []
    for i in range(I):
        A = M[i, :3, :3]
        t = M[i, :3, 3]
        out_v.append(verts @ A.T + t)
        out_f.append(faces + i * V)
        if not mesh.face_normals_binding:
            cni = cn @ np.linalg.inv(A)
            cni /= np.maximum(np.linalg.norm(cni, axis=-1, keepdims=True),
                              1e-20)
            out_cn.append(cni)
    return TriangleMesh.create(
        np.concatenate(out_v, axis=0),
        np.concatenate(out_f, axis=0),
        geom_ids=np.tile(gid, I),
        corner_normals=(None if mesh.face_normals_binding
                        else np.concatenate(out_cn, axis=0)),
        tex_coords=np.tile(tc, (I, 1, 1)),
        device=mesh.vertices.device,
    )


def grid_transforms(n: int, pitch, rows: int = 0) -> np.ndarray:
    """(n, 4, 4) translations laying instances on an XZ grid."""
    rows = rows or int(np.ceil(np.sqrt(n)))
    cols = -(-n // rows)
    px, pz = (pitch if isinstance(pitch, (tuple, list)) else (pitch, pitch))
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        out[i, 0, 3] = (i % cols) * px
        out[i, 2, 3] = (i // cols) * pz
    return out


def sponza_x16_scene(target_tris_per_instance: int = 260_000,
                     instances: int = 16, seed: int = 7, device="cuda"):
    """Config #5 scene: instanced sponza-like courtyard, 16 copies on a
    4x4 grid (~4.2M triangles at full scale).  Returns (scene, camera);
    the BVH is NOT built."""
    dev = resolve_device(device)
    base, cam = sponza_like_scene(target_tris=target_tris_per_instance,
                                  build_bvh=False, seed=seed, device=dev)
    verts = to_numpy(base.mesh.vertices)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    pitch = (float(hi[0] - lo[0]) * 1.05, float(hi[2] - lo[2]) * 1.05)
    mesh16 = instance_mesh(base.mesh,
                           grid_transforms(instances, pitch, rows=4))
    scene = dataclasses.replace(base, mesh=mesh16)
    # camera at first-courtyard eye height, looking across the grid so
    # several instances' colonnades are in frame
    cam = Pinhole.create(
        eye=(0.15 * pitch[0], 0.45 * float(hi[1] - lo[1]),
             0.2 * pitch[1]),
        center=(2.2 * pitch[0], 0.25 * float(hi[1] - lo[1]),
                1.8 * pitch[1]),
        up=(0.0, 1.0, 0.0), fovy=np.deg2rad(62.0), aspect=16.0 / 9.0,
        device=dev)
    return scene, cam
