"""The LBVH kernel's packed records (ops/traversal.py pack_nodes,
pack_prims, kernel_pack) on the CPU: on an LBVH, a SAH tree, an SBVH with
generalized leaves, a sphere BVH and single-leaf trees, all built from
seeded numpy inputs,

- each node record's child boxes and child codes equal the BVH's tables
  (an internal child's code is its index, a leaf's ``~leaf`` with the leaf
  slot, or ``(leaf_first << leaf_bits) | min(leaf_count, max_leaf_size)``);
- the primitive records are the primitives in reference (leaf) order;
- a second query of an unchanged BVH reuses the pack, a rebuilt, replaced
  or refitted one (new tensors, or tables written in place) gets a new one.

The LBVH's records are also held to the JAX package's tree
(visionaray_tpu/ops/lbvh.py) of the same triangles: child boxes bit-equal.
The kernel that reads these records runs only on the card
(tests/test_torch_cuda_lbvh.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.ops import lbvh as jl
from visionaray_tpu.scenes import random_triangles

from visionaray_torch.core.scene import Spheres, TriangleMesh
from visionaray_torch.ops import lbvh, sah
from visionaray_torch.ops import traversal as tt
from visionaray_torch.ops.lbvh import BVH

torch.set_num_threads(1)


def _mesh(n=200, seed=4):
    verts, faces = random_triangles(n=n, seed=seed, extent=4.0, tri_size=1.0)
    return TriangleMesh.create(verts, faces, device="cpu")


def _spheres(n=150, seed=6):
    rng = np.random.default_rng(seed)
    return Spheres.create(rng.uniform(-3.0, 3.0, (n, 3)),
                          np.exp(rng.uniform(np.log(0.01), np.log(0.4), n)),
                          device="cpu")


def _single_generalized(mesh):
    """One leaf over three references (a tree with no internal node)."""
    lo, hi = lbvh.triangle_aabbs(*mesh.corners())
    i32 = dict(dtype=torch.int32)
    return BVH(node_lo=lo[:3].amin(0, keepdim=True),
               node_hi=hi[:3].amax(0, keepdim=True),
               left=torch.zeros(0, **i32), right=torch.zeros(0, **i32),
               parent=torch.full((1,), -1, **i32),
               prim_ids=torch.tensor([2, 0, 1], **i32),
               leaf_first=torch.zeros(1, **i32),
               leaf_count=torch.full((1,), 3, **i32), max_leaf_size=4)


def _trees():
    mesh = _mesh()
    sp = _spheres()
    one = TriangleMesh.create([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]],
                              [[0, 1, 2]], device="cpu")
    return {
        "lbvh": (lbvh.build_lbvh(mesh), "triangle", mesh),
        "sah": (sah.build_sah(mesh), "triangle", mesh),
        "sbvh": (sah.build_sbvh(mesh), "triangle", mesh),
        "spheres": (tt.build_sphere_bvh(sp), "sphere", sp),
        "single_leaf": (lbvh.build_lbvh(one), "triangle", one),
        "single_generalized_leaf": (_single_generalized(mesh), "triangle",
                                    mesh),
    }


TREES = ("lbvh", "sah", "sbvh", "spheres", "single_leaf",
         "single_generalized_leaf")


@pytest.fixture(scope="module")
def trees():
    return _trees()


def _leaf_code(bvh, slot):
    if bvh.leaf_first is None:
        return ~slot
    bits = tt.leaf_bits(bvh)
    count = min(max(int(bvh.leaf_count[slot]), 0), bvh.max_leaf_size)
    return ~((int(bvh.leaf_first[slot]) << bits) | count)


def _code(bvh, child):
    base = bvh.num_leaves - 1
    return child if child < base else _leaf_code(bvh, child - base)


@pytest.mark.parametrize("name", TREES)
def test_node_records_equal_the_tables(trees, name):
    bvh, _, _ = trees[name]
    nodes, root = tt.pack_nodes(bvh)
    base = bvh.num_leaves - 1
    assert nodes.dtype == torch.float32 and nodes.is_contiguous()
    assert tuple(nodes.shape) == (base, 16)
    assert root == (0 if base else _leaf_code(bvh, 0))
    codes = nodes[:, 12:].contiguous().view(torch.int32)
    lo, hi = bvh.node_lo, bvh.node_hi
    for i in range(base):
        lc, rc = int(bvh.left[i]), int(bvh.right[i])
        rec = nodes[i]
        assert torch.equal(rec[[0, 2, 8]], lo[lc])
        assert torch.equal(rec[[1, 3, 9]], hi[lc])
        assert torch.equal(rec[[4, 6, 10]], lo[rc])
        assert torch.equal(rec[[5, 7, 11]], hi[rc])
        assert codes[i].tolist() == [_code(bvh, lc), _code(bvh, rc), 0, 0]


@pytest.mark.parametrize("name", TREES)
def test_leaf_codes_reach_their_primitives(trees, name):
    """Every leaf reached from the records decodes to the references the
    BVH's leaf holds, and the primitive records at those references are
    the primitives, in the leaf's order."""
    bvh, prim, geom = trees[name]
    nodes, root = tt.pack_nodes(bvh)
    prims = tt.pack_prims(bvh, prim, tt.prim_tables(prim, geom))
    bits = tt.leaf_bits(bvh)
    codes = nodes[:, 12:14].contiguous().view(torch.int32).reshape(-1)
    leaves = [c for c in codes.tolist() if c < 0] + ([root] if root < 0
                                                     else [])
    assert len(leaves) == bvh.num_leaves
    if prim == "triangle":
        ref_rows = torch.stack(geom.corners(), dim=1)
        assert torch.equal(prims[..., 3], torch.zeros_like(prims[..., 3]))
    else:
        ref_rows = torch.cat([geom.center, geom.radius[:, None]], dim=1)
    seen = []
    for c in leaves:
        code = ~c
        first, count = code >> bits, code & ((1 << bits) - 1)
        if bvh.leaf_first is None:
            first, count = code, 1
        refs = list(range(first, first + count))
        seen += refs
        for r in refs:
            pid = int(bvh.prim_ids[r])
            got = prims[r, :, :3] if prim == "triangle" else prims[r]
            assert torch.equal(got, ref_rows[pid])
    assert sorted(seen) == list(range(bvh.num_prims))


def test_lbvh_records_equal_jax_tree():
    verts, faces = random_triangles(n=300, seed=3, extent=4.0, tri_size=1.0)
    jb = jl.build_lbvh(JMesh.create(verts, faces))
    tb = lbvh.build_lbvh(TriangleMesh.create(verts, faces, device="cpu"))
    nodes, root = tt.pack_nodes(tb)
    left, right = np.asarray(jb.left), np.asarray(jb.right)
    lo, hi = np.asarray(jb.node_lo), np.asarray(jb.node_hi)
    got = nodes.numpy()
    assert root == 0
    np.testing.assert_array_equal(got[:, [0, 2, 8]], lo[left])
    np.testing.assert_array_equal(got[:, [1, 3, 9]], hi[left])
    np.testing.assert_array_equal(got[:, [4, 6, 10]], lo[right])
    np.testing.assert_array_equal(got[:, [5, 7, 11]], hi[right])


@pytest.mark.parametrize("name", ("lbvh", "sbvh", "spheres"))
def test_pack_reused_while_unchanged(name):
    bvh, prim, geom = _trees()[name]
    first = tt.kernel_pack(bvh, prim, tt.prim_tables(prim, geom))
    again = tt.kernel_pack(bvh, prim, tt.prim_tables(prim, geom))
    assert again[0] is first[0] and again[2] is first[2]
    assert again[1] == first[1]


@pytest.mark.parametrize("change", ("rebuilt", "replaced", "refit",
                                    "vertices_moved"))
def test_pack_renewed_when_the_tree_changes(change):
    mesh = _mesh(120, seed=9)
    bvh = lbvh.build_lbvh(mesh)
    nodes, _, prims = tt.kernel_pack(bvh, "triangle",
                                     tt.prim_tables("triangle", mesh))
    if change == "rebuilt":
        bvh = lbvh.build_lbvh(mesh)
    elif change == "replaced":
        bvh = dataclasses.replace(bvh, node_lo=bvh.node_lo - 1.0)
    elif change == "refit":
        with torch.no_grad():
            bvh.node_hi.add_(0.5)
    else:
        with torch.no_grad():
            mesh.vertices.mul_(2.0)
    tables = tt.prim_tables("triangle", mesh)
    nodes2, _, prims2 = tt.kernel_pack(bvh, "triangle", tables)
    want_nodes, _ = tt.pack_nodes(bvh)
    bits = lambda x: x.view(torch.int32)   # noqa: E731 (codes may be NaN)
    assert torch.equal(bits(nodes2), bits(want_nodes))
    assert torch.equal(prims2, tt.pack_prims(bvh, "triangle", tables))
    if change == "vertices_moved":
        assert nodes2 is nodes and not torch.equal(prims2, prims)
    else:   # a rebuild of the same mesh packs the same records anew
        assert nodes2 is not nodes
        assert torch.equal(bits(nodes2), bits(nodes)) == (change == "rebuilt")


def test_prim_tables_follow_the_geometry():
    mesh = _mesh(60, seed=2)
    a = tt.prim_tables("triangle", mesh)
    assert tt.prim_tables("triangle", mesh) is a
    moved = dataclasses.replace(mesh, vertices=mesh.vertices + 1.0)
    b = tt.prim_tables("triangle", moved)
    assert b is not a and torch.equal(b[0], a[0] + 1.0)
    assert torch.equal(b[1], moved.corners()[1])


def test_leaf_code_overflow_refused():
    mesh = _mesh(30, seed=1)
    bvh = _single_generalized(mesh)
    big = dataclasses.replace(bvh, leaf_first=torch.full(
        (1,), 1 << 28, dtype=torch.int32))
    with pytest.raises(ValueError, match="leaf code"):
        tt.pack_nodes(big)
