"""Carry the JAX package's data across to the port.

Each function takes one object's leaves as a dict of numpy arrays (field
name -> array, static fields as plain values, e.g. ``{f.name:
np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}``) and
builds the port's dataclass on ``device``.  With them a test feeds the
JAX-built scene and ClusterBVH to the port, so kernel parity does not rest
on build parity.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from visionaray_torch.core.camera import MatrixCamera, Pinhole
from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.device import resolve_device
from visionaray_torch.diff.boundary import EdgeAdjacency
from visionaray_torch.ops.cluster_bvh import ClusterBVH
from visionaray_torch.ops.lbvh import tree_depth
from visionaray_torch.shading.lights import AreaLights, PointLights, SpotLights
from visionaray_torch.shading.materials import Materials

_LIGHT_TYPES = {"PointLights": PointLights, "SpotLights": SpotLights,
                "AreaLights": AreaLights}


def _tensor(x, dev):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=dev)


def _build(cls, d: dict, dev, static=()):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        kw[f.name] = v if (f.name in static or v is None) else _tensor(v, dev)
    return cls(**kw)


def mesh_from_arrays(d: dict, device="cuda") -> TriangleMesh:
    dev = resolve_device(device)
    return _build(TriangleMesh, d, dev, static=("face_normals_binding",))


def spheres_from_arrays(d: dict, device="cuda") -> Spheres:
    return _build(Spheres, d, resolve_device(device))


def planes_from_arrays(d: dict, device="cuda") -> Planes:
    return _build(Planes, d, resolve_device(device))


def materials_from_arrays(d: dict, device="cuda") -> Materials:
    return _build(Materials, d, resolve_device(device))


def lights_from_arrays(kind: str, d: dict, device="cuda"):
    """``kind``: the JAX class name (PointLights, SpotLights, AreaLights)."""
    return _build(_LIGHT_TYPES[kind], d, resolve_device(device))


def pinhole_from_arrays(d: dict, device="cuda") -> Pinhole:
    return _build(Pinhole, d, resolve_device(device))


def matrix_camera_from_arrays(d: dict, device="cuda") -> MatrixCamera:
    return _build(MatrixCamera, d, resolve_device(device))


def edge_adjacency_from_arrays(d: dict, device="cuda") -> EdgeAdjacency:
    return _build(EdgeAdjacency, d, resolve_device(device))


def cluster_bvh_from_arrays(d: dict, device="cuda") -> ClusterBVH:
    static = ("num_clusters", "cluster_size", "treelet_size", "num_treelets",
              "heap", "half_boxes")
    bvh = _build(ClusterBVH, d, resolve_device(device), static=static)
    bvh = dataclasses.replace(
        bvh, **{k: (bool(getattr(bvh, k)) if k in ("heap", "half_boxes")
                    else int(getattr(bvh, k))) for k in static})
    # the JAX ClusterBVH carries no depth: read it off the kids columns
    C = bvh.num_clusters
    kids = bvh.nodes[: C - 1, 6:8].to(torch.int64)
    return dataclasses.replace(bvh, depth=tree_depth(kids[:, 0], kids[:, 1]))


def scene_from_arrays(mesh=None, materials=None, lights=None, spheres=None,
                      planes=None, bvh=None, device="cuda") -> Scene:
    """A Scene from per-object dicts; ``lights`` is a (kind, dict) pair or
    a list of them, ``bvh`` a ClusterBVH dict or None."""
    dev = resolve_device(device)
    if lights is not None:
        groups = [lights] if isinstance(lights[0], str) else list(lights)
        built = [lights_from_arrays(k, v, dev) for k, v in groups]
        lights = built[0] if len(built) == 1 else tuple(built)
    return Scene.create(
        mesh=None if mesh is None else mesh_from_arrays(mesh, dev),
        spheres=None if spheres is None else spheres_from_arrays(spheres,
                                                                 dev),
        planes=None if planes is None else planes_from_arrays(planes, dev),
        materials=(None if materials is None
                   else materials_from_arrays(materials, dev)),
        lights=lights,
        bvh=None if bvh is None else cluster_bvh_from_arrays(bvh, dev),
        device=dev)
