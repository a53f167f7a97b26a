"""The port's LBVH build and its host-side introspection against the JAX
package on the CPU (visionaray_tpu/ops/lbvh.py): ``build_lbvh`` on a few
hundred triangles, on duplicate centroids and on a single primitive
(links and prim order equal, boxes bit-equal), ``validate``, ``sah_cost``
(rtol 1e-6), the depth-first, leaf and parent walks (the same visiting
order), and F2: the default ``sponza_like_scene(4000)`` carries an LBVH
equal to the JAX scene's.
"""

import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.ops import lbvh as jl
from visionaray_tpu.scenes import random_triangles
from visionaray_tpu.scenes import sponza_like_scene as j_sponza

from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.ops import lbvh as tl
from visionaray_torch.scenes.sponza_like import sponza_like_scene

torch.set_num_threads(1)
CPU = "cpu"
FIELDS = ("node_lo", "node_hi", "left", "right", "parent", "prim_ids")

CASES = {
    "soup300": dict(n=300, seed=3, extent=4.0, tri_size=1.0),
    "soup97": dict(n=97, seed=8),
    "duplicate_centroids": dict(n=40, seed=2, extent=0.0),
    "single": dict(n=1, seed=1),
}


def _meshes(case):
    verts, faces = random_triangles(**CASES[case])
    return (JMesh.create(verts, faces),
            TriangleMesh.create(verts, faces, device=CPU))


def _assert_same_tree(jb, tb):
    for name in FIELDS:
        a = np.asarray(getattr(jb, name))
        b = getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("case", list(CASES))
def test_build_lbvh_matches_jax(case):
    jm, tm = _meshes(case)
    jb, tb = jl.build_lbvh(jm), tl.build_lbvh(tm)
    _assert_same_tree(jb, tb)
    assert tb.num_nodes == jb.num_nodes and tb.num_prims == jb.num_prims
    assert tb.leaf_first is None and tb.max_leaf_size == 1
    # the depth carried for the stack check is the tree's
    assert tb.depth == tl.tree_depth(tb.left, tb.right) <= 63
    v1, e1, e2 = tm.corners()
    lo, hi = tl.triangle_aabbs(v1, e1, e2)
    checks = tl.validate(tb, lo, hi)
    assert all(checks.values()), checks
    jv1, je1, je2 = jm.corners()
    assert checks == jl.validate(jb, *jl.triangle_aabbs(jv1, je1, je2))
    assert tl.sah_cost(tb) == pytest.approx(jl.sah_cost(jb), rel=1e-6)


@pytest.mark.parametrize("case", ["soup97", "duplicate_centroids"])
def test_host_walks_match_jax(case):
    jm, tm = _meshes(case)
    jb, tb = jl.build_lbvh(jm), tl.build_lbvh(tm)
    got, ref = [], []
    tl.traverse_depth_first(tb, lambda n, leaf: got.append((n, leaf)))
    jl.traverse_depth_first(jb, lambda n, leaf: ref.append((n, leaf)))
    assert got == ref and len(got) == tb.num_nodes
    got, ref = [], []
    tl.traverse_leaves(tb, got.append, node=int(tb.right[0]))
    jl.traverse_leaves(jb, ref.append, node=int(jb.right[0]))
    assert got == ref and got
    for node in (tb.num_nodes - 1, tb.num_leaves - 1, 3):
        got, ref = [], []
        tl.traverse_parents(tb, node, got.append)
        jl.traverse_parents(jb, node, ref.append)
        assert got == ref and got[-1] == 0


def test_build_from_aabbs_of_spheres_matches_jax():
    rng = np.random.default_rng(4)
    c = rng.uniform(-3, 3, (150, 3)).astype(np.float32)
    r = np.exp(rng.uniform(np.log(1e-9), np.log(2.0), (150, 1))).astype(
        np.float32)
    jb = jl.build_lbvh_from_aabbs(c - r, c + r)
    tb = tl.build_lbvh_from_aabbs(torch.tensor(c - r), torch.tensor(c + r))
    _assert_same_tree(jb, tb)


def test_default_sponza_scene_carries_jax_lbvh():
    """F2: the default scene builds an LBVH, as the JAX package's does."""
    js, _ = j_sponza(target_tris=4000)
    ts, _ = sponza_like_scene(target_tris=4000, device=CPU)
    assert isinstance(ts.bvh, tl.BVH)
    _assert_same_tree(js.bvh, ts.bvh)
    bare, _ = sponza_like_scene(target_tris=4000, build_bvh=False,
                                device=CPU)
    assert bare.bvh is None
