"""The sponza-class courtyard and its x16 instancing, as numpy arrays.

A frozen copy of the program's scene generators (``sponza_like_mesh``,
``instance_mesh`` and ``grid_transforms``, and the two cameras), so that
the benchmark makes its inputs itself and hands the same arrays to the
program and to the plain reference.  The arithmetic is kept step for step
(float32 numpy), so the arrays equal the program's own generator's.

``build(scene, seed)`` takes a configuration's ``scene`` section:
``target_tris`` (per instance), ``instances`` (1, or 16 on a 4 x 4
grid), ``grid_rows``.  The seed moves only the banners' vertex jitter, so
every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np


def _grid_quad(p00, p10, p01, res_u, res_v):
    p00 = np.asarray(p00, np.float32)
    du = (np.asarray(p10, np.float32) - p00) / res_u
    dv = (np.asarray(p01, np.float32) - p00) / res_v
    iu, iv = np.meshgrid(np.arange(res_u + 1), np.arange(res_v + 1),
                         indexing="ij")
    verts = (p00[None, None]
             + iu[..., None] * du[None, None]
             + iv[..., None] * dv[None, None]).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(res_u), np.arange(res_v), indexing="ij")
    a = (i * (res_v + 1) + j).reshape(-1)
    b, c = a + 1, a + (res_v + 1)
    d = c + 1
    faces = np.stack([np.stack([a, c, d], -1), np.stack([a, d, b], -1)],
                     axis=1).reshape(-1, 3)
    return verts.astype(np.float32), faces.astype(np.int32)


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
    i, j = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    a = (i * segments + j).reshape(-1)
    b = (i * segments + (j + 1) % segments).reshape(-1)
    c = ((i + 1) * segments + j).reshape(-1)
    d = ((i + 1) * segments + (j + 1) % segments).reshape(-1)
    faces = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                     axis=1).reshape(-1, 3)
    return verts, faces.astype(np.int32)


def sponza_like_mesh(target_tris: int, seed: int):
    """(verts (V, 3) f32, faces (F, 3) i32, material ids (F,) i32)."""
    rng = np.random.default_rng(int(seed) & (2**63 - 1))
    scale = max(0.05, min(4.0, target_tris / 260_000.0))
    col_seg = max(8, int(48 * np.sqrt(scale)))
    col_rings = max(4, int(40 * np.sqrt(scale)))
    floor_res = max(8, int(64 * np.sqrt(scale)))

    W, D, H = 24.0, 12.0, 10.0
    parts = []
    patches = [
        ((0, 0, 0), (W, 0, 0), (0, 0, D), 0),
        ((0, H, 0), (W, H, 0), (0, H, D), 1),
        ((0, 0, 0), (W, 0, 0), (0, H, 0), 1),
        ((0, 0, D), (W, 0, D), (0, H, D), 1),
        ((0, 0, 0), (0, 0, D), (0, H, 0), 1),
        ((W, 0, 0), (W, 0, D), (W, H, 0), 1),
    ]
    for p00, p10, p01, gid in patches:
        v, f = _grid_quad(p00, p10, p01, floor_res, floor_res // 2)
        parts.append((v, f, gid))

    n_cols = 8
    for i in range(n_cols):
        x = 2.0 + i * (W - 4.0) / (n_cols - 1)
        for z in (3.0, D - 3.0):
            v, f = _fluted_column((x, z), 0.5, H * 0.72, col_seg, col_rings)
            parts.append((v, f, 2))
            v2, f2 = _fluted_column((x, z), 0.75, H * 0.06, col_seg // 2, 3,
                                    flutes=4)
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


# the courtyard's camera: eye, center, up, fovy (radians), aspect
COURTYARD_CAMERA = dict(eye=(2.5, 2.2, 6.0), center=(18.0, 4.0, 6.0),
                        up=(0.0, 1.0, 0.0), fovy=float(np.deg2rad(55.0)),
                        aspect=16.0 / 9.0)


def _grid_transforms(n: int, pitch, rows: int) -> np.ndarray:
    cols = -(-n // rows)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        out[i, 0, 3] = (i % cols) * pitch[0]
        out[i, 2, 3] = (i // cols) * pitch[1]
    return out


def _instanced(verts, faces, gids, instances: int, rows: int):
    """The courtyard repeated on an XZ grid, 5% apart, and the camera that
    looks across the grid from the first courtyard."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    pitch = (float(hi[0] - lo[0]) * 1.05, float(hi[2] - lo[2]) * 1.05)
    M = _grid_transforms(instances, pitch, rows)
    V = verts.shape[0]
    out_v = [verts @ M[i, :3, :3].T + M[i, :3, 3] for i in range(instances)]
    out_f = [faces + i * V for i in range(instances)]
    height = float(hi[1] - lo[1])
    cam = dict(eye=(0.15 * pitch[0], 0.45 * height, 0.2 * pitch[1]),
               center=(2.2 * pitch[0], 0.25 * height, 1.8 * pitch[1]),
               up=(0.0, 1.0, 0.0), fovy=float(np.deg2rad(62.0)),
               aspect=16.0 / 9.0)
    return (np.concatenate(out_v, axis=0).astype(np.float32),
            np.concatenate(out_f, axis=0).astype(np.int32),
            np.tile(gids, instances), cam)


def build(scene: dict, seed: int):
    """(verts, faces, material ids, camera dict) of a configuration's
    ``scene`` section."""
    verts, faces, gids = sponza_like_mesh(int(scene["target_tris"]), seed)
    n = int(scene.get("instances", 1))
    if n == 1:
        return verts, faces, gids, dict(COURTYARD_CAMERA)
    return _instanced(verts, faces, gids, n, int(scene["grid_rows"]))
