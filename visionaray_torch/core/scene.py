"""Scene container (port of core/scene.py).

Primitive id convention as in the reference: triangles [0, F), then spheres
[F, F+S), then planes [F+S, F+S+P); ``geom_id`` is the material index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from visionaray_torch.core.types import AABB
from visionaray_torch.core.vecmath import cross, normalize
from visionaray_torch.device import resolve_device, take
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


@dataclass
class TriangleMesh:
    """Indexed triangle mesh; v1/e1/e2 are derived from ``vertices``."""

    vertices: Any        # (V, 3) f32
    faces: Any           # (F, 3) i32
    geom_ids: Any        # (F,) i32 material index per face
    normals: Any         # (F, 3) f32 per-face geometric normals
    corner_normals: Any  # (F, 3, 3) f32 per-corner shading normals
    tex_coords: Any      # (F, 3, 2) f32 per-corner texture coords
    face_normals_binding: bool = True

    @staticmethod
    def create(vertices, faces, geom_ids=None, corner_normals=None,
               tex_coords=None, device="cuda") -> "TriangleMesh":
        dev = resolve_device(device)
        vertices = _f32(vertices, dev)
        faces = _i32(faces, dev)
        F = faces.shape[0]
        geom_ids = (torch.zeros((F,), dtype=torch.int32, device=dev)
                    if geom_ids is None else _i32(geom_ids, dev))
        v1 = take(vertices, faces[:, 0])
        v2 = take(vertices, faces[:, 1])
        v3 = take(vertices, faces[:, 2])
        face_n = normalize(cross(v2 - v1, v3 - v1))
        if corner_normals is None:
            binding = True
            corner_normals = face_n[:, None, :].expand(F, 3, 3)
        else:
            binding = False
            corner_normals = _f32(corner_normals, dev)
        tex_coords = (torch.zeros((F, 3, 2), dtype=torch.float32, device=dev)
                      if tex_coords is None else _f32(tex_coords, dev))
        return TriangleMesh(vertices=vertices, faces=faces, geom_ids=geom_ids,
                            normals=face_n, corner_normals=corner_normals,
                            tex_coords=tex_coords,
                            face_normals_binding=binding)

    @property
    def num_prims(self):
        return self.faces.shape[0]

    def corners(self):
        """(v1, e1, e2) gathered from the vertex buffer."""
        v1 = take(self.vertices, self.faces[:, 0])
        v2 = take(self.vertices, self.faces[:, 1])
        v3 = take(self.vertices, self.faces[:, 2])
        return v1, v2 - v1, v3 - v1


@dataclass
class Spheres:
    center: Any    # (S, 3)
    radius: Any    # (S,)
    geom_ids: Any  # (S,) i32

    @staticmethod
    def create(center, radius, geom_ids=None, device="cuda") -> "Spheres":
        dev = resolve_device(device)
        center = _f32(center, dev).reshape(-1, 3)
        radius = _f32(radius, dev).reshape(-1)
        geom_ids = (torch.zeros(radius.shape, dtype=torch.int32, device=dev)
                    if geom_ids is None else _i32(geom_ids, dev))
        return Spheres(center, radius, geom_ids)

    @property
    def num_prims(self):
        return self.radius.shape[0]


@dataclass
class Planes:
    """Infinite planes dot(n, x) = offset."""

    normal: Any    # (P, 3)
    offset: Any    # (P,)
    geom_ids: Any  # (P,) i32

    @staticmethod
    def create(normal, offset, geom_ids=None, device="cuda") -> "Planes":
        dev = resolve_device(device)
        normal = _f32(normal, dev).reshape(-1, 3)
        offset = _f32(offset, dev).reshape(-1)
        geom_ids = (torch.zeros(offset.shape, dtype=torch.int32, device=dev)
                    if geom_ids is None else _i32(geom_ids, dev))
        return Planes(normal, offset, geom_ids)

    @property
    def num_prims(self):
        return self.offset.shape[0]


@dataclass
class Scene:
    """Geometry groups + materials + lights.  ``bvh`` accelerates the
    triangle mesh: a ClusterBVH, a flat ``ops.lbvh.BVH`` (LBVH, SAH or
    SBVH build) or None; ``sphere_bvh`` a flat BVH over the spheres
    (``ops.traversal.build_sphere_bvh``) or None; ``textures`` a
    ``shading.texture.TextureAtlas`` (one texture per material) or None;
    ``volumes`` the ``kernels.volume.Volumes`` that ``algo="volume"``
    marches, or None."""

    mesh: Optional[TriangleMesh]
    spheres: Optional[Spheres]
    planes: Optional[Planes]
    materials: Materials
    lights: Any
    bvh: Any = None
    textures: Any = None
    volumes: Any = None
    sphere_bvh: Any = None

    @staticmethod
    def create(mesh=None, spheres=None, planes=None, materials=None,
               lights=None, bvh=None, device="cuda",
               sphere_bvh=None, textures=None, volumes=None) -> "Scene":
        if materials is None:
            materials = Materials.default(device=device)
        if lights is None:
            lights = PointLights.none(device=device)
        return Scene(mesh=mesh, spheres=spheres, planes=planes,
                     materials=materials, lights=lights, bvh=bvh,
                     textures=textures, volumes=volumes,
                     sphere_bvh=sphere_bvh)

    @property
    def device(self) -> torch.device:
        return self.materials.mtype.device

    @property
    def num_triangles(self):
        return 0 if self.mesh is None else self.mesh.num_prims

    @property
    def num_spheres(self):
        return 0 if self.spheres is None else self.spheres.num_prims

    @property
    def num_planes(self):
        return 0 if self.planes is None else self.planes.num_prims

    def bbox(self) -> AABB:
        """Scene bounds over finite geometry and volume boxes (planes
        excluded)."""
        dev = self.device
        lo = torch.full((3,), 3.4e38, dtype=torch.float32, device=dev)
        hi = torch.full((3,), -3.4e38, dtype=torch.float32, device=dev)
        if self.mesh is not None:
            lo = torch.minimum(lo, torch.amin(self.mesh.vertices, dim=0))
            hi = torch.maximum(hi, torch.amax(self.mesh.vertices, dim=0))
        if self.spheres is not None:
            r = self.spheres.radius[:, None]
            lo = torch.minimum(lo, torch.amin(self.spheres.center - r, dim=0))
            hi = torch.maximum(hi, torch.amax(self.spheres.center + r, dim=0))
        if self.volumes is not None:
            lo = torch.minimum(lo, torch.amin(self.volumes.lo, dim=0))
            hi = torch.maximum(hi, torch.amax(self.volumes.hi, dim=0))
        return AABB(lo, hi)
