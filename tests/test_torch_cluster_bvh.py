"""visionaray_torch ClusterBVH build vs the JAX build on the CPU: the tables
must be equal, not merely close (every sort is stable on both sides)."""

import dataclasses

import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.ops.pallas import cluster_bvh as jcb
from visionaray_tpu.scenes import random_triangles
from visionaray_tpu.scenes import sponza_like as jsponza

from visionaray_torch import convert
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.ops import cluster_bvh as tcb
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.lbvh import refit, triangle_aabbs
from visionaray_torch.scenes import sponza_like as tsponza

torch.set_num_threads(1)
CPU = "cpu"
TABLES = ("nodes", "tris", "treelet_lo", "treelet_hi", "treelet_roots")
STATICS = ("num_clusters", "cluster_size", "treelet_size", "num_treelets",
           "heap", "half_boxes")


def _meshes(verts, faces, gids=None):
    return (JMesh.create(verts, faces, geom_ids=gids),
            TriangleMesh.create(verts, faces, geom_ids=gids, device=CPU))


def _assert_same_bvh(jb, tb):
    for k in STATICS:
        assert getattr(tb, k) == getattr(jb, k), k
    for k in TABLES:
        ref = np.asarray(getattr(jb, k))
        got = getattr(tb, k).numpy()
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


CASES = {
    "random96_K8_T4": (lambda: random_triangles(96, seed=7, extent=3.0,
                                                tri_size=0.8), 8, 4, True),
    "random160_K16_T4_half_boxes": (
        lambda: random_triangles(160, seed=11, extent=3.0, tri_size=0.7),
        16, 4, True),
    "random96_K8_T4_longest_axis": (
        lambda: random_triangles(96, seed=7, extent=3.0, tri_size=0.8),
        8, 4, False),
    "sponza4000_K8_T16": (
        lambda: jsponza.sponza_like_mesh(4000)[:2], 8, 16, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kd_build_tables_equal(case):
    make, K, T, sah = CASES[case]
    verts, faces = make()
    jm, tm = _meshes(verts, faces)
    jb = jcb.build_cluster_bvh(jm, cluster_size=K, treelet_size=T,
                               sah_axis=sah)
    tb = tcb.build_cluster_bvh(tm, cluster_size=K, treelet_size=T,
                               sah_axis=sah)
    _assert_same_bvh(jb, tb)
    assert tb.half_boxes == (K >= 16)


def test_sponza_mesh_is_a_copy():
    for target in (4000, 20000):
        for a, b in zip(tsponza.sponza_like_mesh(target),
                        jsponza.sponza_like_mesh(target)):
            np.testing.assert_array_equal(a, b)
    verts, faces, gids = tsponza.sponza_like_mesh(4000)
    assert len(faces) == 4804


def test_sponza_scene_matches():
    js, jc = jsponza.sponza_like_scene(target_tris=4000, build_bvh=False)
    ts, tc = tsponza.sponza_like_scene(target_tris=4000, build_bvh=False,
                                       device=CPU)
    for f in ("vertices", "faces", "geom_ids"):
        np.testing.assert_array_equal(getattr(ts.mesh, f).numpy(),
                                      np.asarray(getattr(js.mesh, f)))
    # face normals go through rsqrt, which rounds differently in XLA and
    # torch: one ulp
    np.testing.assert_allclose(ts.mesh.normals.numpy(),
                               np.asarray(js.mesh.normals), rtol=0,
                               atol=2.4e-7)
    for f in dataclasses.fields(ts.materials):
        np.testing.assert_array_equal(getattr(ts.materials, f.name).numpy(),
                                      np.asarray(getattr(js.materials,
                                                         f.name)))
    np.testing.assert_array_equal(ts.lights.position.numpy(),
                                  np.asarray(js.lights.position))
    for f in ("eye", "center", "up", "fovy", "aspect"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))


def test_sorted_cluster_data_equal():
    verts, faces = random_triangles(100, seed=3, extent=4.0)
    jm, tm = _meshes(verts, faces)
    ref = jcb._sorted_cluster_data(*jm.corners(), 16)
    got = tcb._sorted_cluster_data(*tm.corners(), 16)
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            np.int64 if np.asarray(b).dtype == np.uint32 else
            np.asarray(b).dtype))


def test_converted_bvh_is_identical():
    verts, faces = random_triangles(96, seed=7, extent=3.0, tri_size=0.8)
    jm, _ = _meshes(verts, faces)
    jb = jcb.build_cluster_bvh(jm, cluster_size=8, treelet_size=4)
    d = {f.name: (getattr(jb, f.name) if f.name in STATICS
                  else np.asarray(getattr(jb, f.name)))
         for f in dataclasses.fields(jb)}
    _assert_same_bvh(jb, convert.cluster_bvh_from_arrays(d, device=CPU))


def test_refit_matches_heap_levels():
    rng = np.random.default_rng(0)
    lo = rng.normal(size=(16, 3)).astype(np.float32)
    hi = lo + rng.random((16, 3)).astype(np.float32)
    left = 2 * torch.arange(15) + 1
    nlo, nhi = refit(left, left + 1, torch.as_tensor(lo),
                     torch.as_tensor(hi))
    assert torch.equal(nlo[0], torch.as_tensor(lo.min(0)))
    assert torch.equal(nhi[0], torch.as_tensor(hi.max(0)))
    v1 = torch.as_tensor(lo)
    alo, ahi = triangle_aabbs(v1, torch.ones(16, 3), -torch.ones(16, 3))
    assert torch.equal(alo, v1 - 1) and torch.equal(ahi, v1 + 1)


def test_unported_builds_raise():
    """The radix builds (row 1e) are ported: treelet_size=0 and a treelet
    build of fewer than two treelets give the JAX build's radix tree.  The
    kernel wrapper refuses row 1f's options where the tree cannot take
    them: wide descent on a radix tree, the half skip on a kd build with
    K < 16 (no half boxes)."""
    verts, faces = random_triangles(40, seed=1)
    jm, tm = _meshes(verts, faces)
    for T in (0, 8):   # T = 8: 8 clusters make S = 1 treelet
        tb = tcb.build_cluster_bvh(tm, cluster_size=8, treelet_size=T)
        jb = jcb.build_cluster_bvh(jm, cluster_size=8, treelet_size=T)
        assert (tb.num_clusters, tb.heap, tb.treelet_size) == (5, False, 0)
        for k in ("nodes", "tris"):
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(getattr(jb, k)))
    rays = torch.zeros((4096, 8))
    with pytest.raises(ValueError, match="heap"):
        trav.cluster_traverse(rays, tb.nodes, tb.tris, tb.num_clusters,
                              tb.cluster_size, 4096, heap=False,
                              depth=tb.depth, fanout=8)
    kd = tcb.build_cluster_bvh(tm, cluster_size=8, treelet_size=2)
    assert kd.heap and not kd.half_boxes
    assert not kd.tris.reshape(-1, 16)[:, 10:].any()
    with pytest.raises(ValueError, match="half boxes"):
        trav.cluster_traverse(rays, kd.nodes, kd.tris, kd.num_clusters,
                              kd.cluster_size, 4096, half_skip=True)
    assert tcb.pick_cluster_size(259_656) == jcb.pick_cluster_size(259_656)
    assert tcb.pick_cluster_size(10**6) == jcb.pick_cluster_size(10**6)
