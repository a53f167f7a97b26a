"""The port's teapot and instanced scenes (visionaray_torch/scenes/
teapot.py, instanced.py) against the JAX package's on the CPU:

- ``teapot_mesh`` equal to JAX's; ``teapot_scene``: mesh, plane,
  materials, light and camera equal, and its LBVH equal to JAX's, array
  for array;
- ``grid_transforms`` and ``instance_mesh`` (a rotated and scaled copy of
  a mesh with per-corner normals) equal to JAX's;
- ``sponza_x16_scene`` at target 2,000 triangles a copy (the generator
  makes 4,804), 16 copies: vertices, faces, ids and UVs equal, no BVH,
  the camera equal.

The face normals a mesh derives from its vertices differ from JAX's in
the last bit (XLA's normalize rounds differently): atol 2.5e-7; on the
teapot's lid tip, where the edge cross products cancel, 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.scenes import instanced as jinst
from visionaray_tpu.scenes import teapot as jteapot

from visionaray_torch import scenes as tscenes
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.scenes import instanced as tinst
from visionaray_torch.scenes import teapot as tteapot

torch.set_num_threads(1)
CPU = "cpu"
NORMAL_ATOL = 2.5e-7
# the lid's tip is a ring of radius 1e-3: its triangles' edge cross
# products cancel, and the last-bit differences grow to 4.3e-6 (16 of
# 1,584 components at detail 8)
TEAPOT_NORMAL_ATOL = 1e-5
BVH_FIELDS = ("node_lo", "node_hi", "left", "right", "parent", "prim_ids")


def _same(tobj, jobj, derived=(), atol=NORMAL_ATOL):
    for f in dataclasses.fields(jobj):
        j, t = getattr(jobj, f.name), getattr(tobj, f.name)
        if j is None or isinstance(j, (bool, int, str)):
            assert t == j or (t is None and j is None), f.name
            continue
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if f.name in derived:
            np.testing.assert_allclose(t, np.asarray(j), rtol=0,
                                       atol=atol, err_msg=f.name)
        else:
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=f.name)


def _same_mesh(tm, jm, atol=NORMAL_ATOL):
    _same(tm, jm, derived={"normals"} | (
        {"corner_normals"} if jm.face_normals_binding else set()),
        atol=atol)


def _same_camera(tc, jc):
    for f in ("eye", "center", "up", "fovy", "aspect", "z_near", "z_far"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))


@pytest.mark.parametrize("detail", [8, 24])
def test_teapot_mesh_matches_jax(detail):
    tv, tf = tteapot.teapot_mesh(detail)
    jv, jf = jteapot.teapot_mesh(detail)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_teapot_scene_matches_jax():
    ts, tc = tscenes.teapot_scene(detail=8, device=CPU)
    js, jc = jteapot.teapot_scene(detail=8)
    _same_mesh(ts.mesh, js.mesh, atol=TEAPOT_NORMAL_ATOL)
    for part in ("planes", "materials"):
        _same(getattr(ts, part), getattr(js, part))
    np.testing.assert_array_equal(ts.lights.position.numpy(),
                                  np.asarray(js.lights.position))
    for f in BVH_FIELDS:
        a, b = np.asarray(getattr(js.bvh, f)), getattr(ts.bvh, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    _same_camera(tc, jc)
    bare, _ = tscenes.teapot_scene(detail=8, build_bvh=False, device=CPU)
    assert bare.bvh is None


def test_grid_transforms_match_jax():
    for n, pitch, rows in ((16, (3.0, 2.0), 4), (5, 1.5, 0), (7, [2, 1], 2)):
        np.testing.assert_array_equal(tinst.grid_transforms(n, pitch, rows),
                                      jinst.grid_transforms(n, pitch, rows))


def test_instance_mesh_with_corner_normals_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    faces = np.stack([rng.permutation(12)[:3] for _ in range(10)]).astype(
        np.int32)
    cn = rng.normal(size=(10, 3, 3)).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=-1, keepdims=True)
    uv = rng.uniform(0, 1, (10, 3, 2)).astype(np.float32)
    gid = rng.integers(0, 3, 10).astype(np.int32)
    M = jinst.grid_transforms(3, 2.5)
    c, s = np.cos(0.7), np.sin(0.7)
    M[1, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * 1.5
    tm = tinst.instance_mesh(TriangleMesh.create(
        verts, faces, gid, cn, uv, device=CPU), M)
    jm = jinst.instance_mesh(JMesh.create(verts, faces, gid, cn, uv), M)
    assert tm.num_prims == 30 and not tm.face_normals_binding
    _same_mesh(tm, jm)


def test_sponza_x16_scene_matches_jax():
    ts, tc = tscenes.sponza_x16_scene(target_tris_per_instance=2000,
                                      device=CPU)
    js, jc = jinst.sponza_x16_scene(target_tris_per_instance=2000)
    assert ts.num_triangles == js.num_triangles == 16 * 4804
    assert ts.bvh is None and js.bvh is None
    _same_mesh(ts.mesh, js.mesh)
    _same(ts.materials, js.materials)
    _same_camera(tc, jc)
