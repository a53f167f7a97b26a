"""Wavefront OBJ/MTL loader (port of io/obj.py: the parser a numpy copy,
the mesh, materials, textures and LBVH built on ``device``).

Python/numpy re-implementation of the reference loader semantics
(src/common/obj_loader.cpp):

- triangle-fan triangulation of polygons: (f0, f[k-1], f[k])
  (store_faces, obj_loader.cpp:95-140)
- 1-based and negative index remap: i > 0 ? i-1 : size + i
  (remap_index, obj_loader.cpp:51-56)
- per-corner shading normals / tex coords only when ALL corners have them
- MTL: newmtl/Ka/Kd/Ks/Ke/Ns/map_Kd parsed; Ke != 0 -> emissive material,
  else plastic with ca=Ka, cd=Kd, cs=Ks, ka=kd=ks=1, exp=Ns
  (add_material, obj_loader.cpp:256-296)
- default material plastic(ca=.2, cd=.8, cs=.1, exp=32)
  (make_default_material, obj_loader.cpp:36-47)
- geom_id = index of the most recent usemtl's material (0 if none)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from visionaray_torch.core.scene import Scene, TriangleMesh
from visionaray_torch.device import resolve_device
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials


def _remap(i: int, size: int) -> int:
    return i - 1 if i > 0 else size + i


def parse_mtl(path: str) -> dict:
    """Parse an MTL file into {name: dict(ka, kd, ks, ke, ns, map_kd)}."""
    matlib = {}
    cur = None
    if not os.path.exists(path):
        return matlib
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            key = parts[0].lower()
            if key == "newmtl":
                name = parts[1] if len(parts) > 1 else ""
                cur = dict(ka=(0.2, 0.2, 0.2), kd=(0.8, 0.8, 0.8),
                           ks=(0.1, 0.1, 0.1), ke=(0.0, 0.0, 0.0),
                           ns=32.0, map_kd=None)
                matlib[name] = cur
            elif cur is None:
                continue
            elif key in ("ka", "kd", "ks", "ke") and len(parts) >= 4:
                cur[key] = tuple(float(x) for x in parts[1:4])
            elif key == "ns" and len(parts) >= 2:
                cur["ns"] = float(parts[1])
            elif key == "map_kd" and len(parts) >= 2:
                cur["map_kd"] = parts[-1]
    return matlib


def _mtl_to_material(m: dict, device) -> Materials:
    if float(np.linalg.norm(m["ke"])) > 0.0:
        return Materials.emissive(ce=m["ke"], ls=1.0, device=device)
    return Materials.plastic(cd=m["kd"], kd=1.0, cs=m["ks"], ks=1.0,
                             specular_exp=m["ns"], ca=m["ka"], ka=1.0,
                             device=device)


def _default_material(device) -> Materials:
    return Materials.plastic(cd=(0.8, 0.8, 0.8), kd=1.0, cs=(0.1, 0.1, 0.1),
                             ks=1.0, specular_exp=32.0, ca=(0.2, 0.2, 0.2),
                             ka=1.0, device=device)


def load_obj(path: str, device="cuda"):
    """Load an OBJ file. Returns (TriangleMesh, Materials, texture_names),
    the mesh and materials on ``device``.

    texture_names: per-material map_Kd path (or None), for the texture
    subsystem to resolve.
    """
    dev = resolve_device(device)
    vertices: list = []
    tex_coords: list = []
    normals: list = []

    faces_out: list = []          # (3,) vertex indices
    corner_normals: list = []     # (3,3) or None per face
    corner_uvs: list = []         # (3,2) or None per face
    geom_ids: list = []

    materials: list = []
    texture_names: list = []
    matlib: dict = {}
    cur_gid = 0
    base_dir = os.path.dirname(os.path.abspath(path))

    def parse_corner(tok: str):
        comps = tok.split("/")
        vi = int(comps[0])
        ti = int(comps[1]) if len(comps) > 1 and comps[1] else None
        ni = int(comps[2]) if len(comps) > 2 and comps[2] else None
        return vi, ti, ni

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
            elif key == "vt" and len(parts) >= 3:
                tex_coords.append([float(parts[1]), float(parts[2])])
            elif key == "vn" and len(parts) >= 4:
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif key == "mtllib" and len(parts) >= 2:
                matlib.update(parse_mtl(os.path.join(base_dir, parts[1])))
            elif key == "usemtl" and len(parts) >= 2:
                name = parts[1]
                m = matlib.get(name)
                if m is None:
                    m = dict(ka=(0.2, 0.2, 0.2), kd=(0.8, 0.8, 0.8),
                             ks=(0.1, 0.1, 0.1), ke=(0.0, 0.0, 0.0),
                             ns=32.0, map_kd=None)
                materials.append(_mtl_to_material(m, dev))
                texture_names.append(
                    os.path.join(base_dir, m["map_kd"]) if m["map_kd"]
                    else None)
                cur_gid = len(materials) - 1
            elif key == "f" and len(parts) >= 4:
                corners = [parse_corner(t) for t in parts[1:]]
                nv, ntc, nn = len(vertices), len(tex_coords), len(normals)
                # fan triangulation (store_faces)
                for k in range(2, len(corners)):
                    tri = [corners[0], corners[k - 1], corners[k]]
                    vis = [_remap(c[0], nv) for c in tri]
                    faces_out.append(vis)
                    geom_ids.append(cur_gid)
                    if all(c[2] is not None for c in tri):
                        corner_normals.append(
                            [normals[_remap(c[2], nn)] for c in tri])
                    else:
                        corner_normals.append(None)
                    if all(c[1] is not None for c in tri):
                        corner_uvs.append(
                            [tex_coords[_remap(c[1], ntc)] for c in tri])
                    else:
                        corner_uvs.append(None)

    if not materials:
        materials.append(_default_material(dev))
        texture_names.append(None)

    verts = np.asarray(vertices, np.float32)
    faces = np.asarray(faces_out, np.int32)
    gids = np.asarray(geom_ids, np.int32)

    have_all_normals = corner_normals and all(
        c is not None for c in corner_normals)
    cn = (np.asarray(corner_normals, np.float32)
          if have_all_normals else None)
    have_all_uvs = corner_uvs and all(c is not None for c in corner_uvs)
    uv = np.asarray(corner_uvs, np.float32) if have_all_uvs else None

    mesh = TriangleMesh.create(verts.reshape(-1, 3), faces.reshape(-1, 3),
                               geom_ids=gids, corner_normals=cn,
                               tex_coords=uv, device=dev)
    return mesh, Materials.concatenate(materials), texture_names


def load_obj_scene(path: str, lights: Optional[PointLights] = None,
                   build_bvh: bool = True, texture_resolution: int = 256,
                   device="cuda") -> Scene:
    """Load an OBJ into a ready-to-render Scene on ``device`` (viewer
    startup path, viewer.cpp:745-783: load_obj + build).

    map_Kd textures are loaded at load time like the reference
    (obj_loader.cpp:202-246 resolves texture files into the model) and
    packed into a TextureAtlas bound to the scene; missing files are
    skipped with a warning, matching the reference's non-fatal handling.
    ``build_bvh``: an LBVH (``ops.lbvh.build_lbvh``), built on ``device``.
    """
    import warnings

    dev = resolve_device(device)
    mesh, materials, tex_names = load_obj(path, device=dev)
    textures = None
    images = {}
    for gid, name in enumerate(tex_names):
        if not name:
            continue
        if not os.path.exists(name):
            warnings.warn(f"map_Kd texture not found, skipping: {name}")
            continue
        from visionaray_torch.io.image import load_image
        images[gid] = load_image(name, srgb=True)
    if images:
        from visionaray_torch.shading.texture import TextureAtlas
        textures = TextureAtlas.pack(images, materials.num_materials,
                                     resolution=texture_resolution,
                                     device=dev)
    scene = Scene.create(mesh=mesh, materials=materials,
                         lights=lights or PointLights.none(device=dev),
                         textures=textures, device=dev)
    if build_bvh:
        from visionaray_torch.ops.lbvh import build_lbvh
        scene.bvh = build_lbvh(mesh)
    return scene


def save_obj(path: str, mesh: TriangleMesh):
    """Write a TriangleMesh back to OBJ (round-trip tests)."""
    verts = mesh.vertices.detach().cpu().numpy()
    faces = mesh.faces.cpu().numpy()
    with open(path, "w") as f:
        f.write("# visionaray_torch export\n")
        f.writelines(f"v {v[0]} {v[1]} {v[2]}\n" for v in verts)
        f.writelines(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n" for t in faces)
