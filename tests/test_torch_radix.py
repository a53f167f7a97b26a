"""The radix-tree ClusterBVH (PERF.md row 1e) vs the JAX package on the CPU.

- ``build_radix_tree`` against JAX ``lbvh.build_radix_tree`` on seeded
  sorted codes with runs of duplicates: left, right and parent equal.
- ``build_cluster_bvh(treelet_size=0)`` tables equal to JAX's on the
  48-triangle fixture of test_pallas_traverse.py at K=16 (C=3, not a power
  of two) and K=48 (C=1), and the fewer-than-two-treelets fallback of the
  treelet build on sponza_like(4000) at K=32, T=256 (C=151).
- Closest-hit and any-hit on those trees (the port's plain version behind
  the kernel wrapper, on CPU tensors) against JAX's cluster_closest_hit and
  cluster_any_hit with interpret=True: hit equal, t rtol 1e-5, prim equal
  where the nearest hit is unique.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops import lbvh as jlbvh
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.scenes import random_triangles
from visionaray_tpu.scenes import sponza_like as jsponza

from visionaray_torch import convert
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import lbvh
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.intersect import intersect_triangle
from visionaray_torch.ops.trace import intersect_triangles_brute

torch.set_num_threads(1)
CPU = "cpu"
STATICS = ("num_clusters", "cluster_size", "treelet_size", "num_treelets",
           "heap", "half_boxes")


@pytest.mark.parametrize("n,span", [(2, 4), (3, 1), (17, 8), (300, 64),
                                    (513, 1 << 30)])
def test_build_radix_tree_equal(n, span):
    """Sorted codes drawn from ``span`` values: small spans make long runs
    of equal codes, which the sorted-index tiebreak must split."""
    codes = np.sort(np.random.default_rng(n).integers(0, span, n)
                    ).astype(np.uint32)
    if n > 3:
        assert len(np.unique(codes)) < n or span == 1 << 30
    got = lbvh.build_radix_tree(torch.as_tensor(codes.astype(np.int64)))
    ref = jlbvh.build_radix_tree(jnp.asarray(codes))
    for name, a, b in zip(("left", "right", "parent"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_clz32_exact():
    x = torch.tensor([0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
                      12345, 1 << 20], dtype=torch.int64)
    want = [32 - int(v).bit_length() for v in x.tolist()]
    assert lbvh.clz32(x).tolist() == want


def _fixture48():
    verts, faces = random_triangles(48, seed=5, extent=3.0, tri_size=1.0)
    rng = np.random.default_rng(1)
    cent = verts.reshape(-1, 3, 3).mean(axis=1)
    targets = cent[rng.integers(0, len(cent), 24)]
    o = np.stack([rng.uniform(-1, 1, 32), rng.uniform(-1, 1, 32),
                  np.full(32, -9.0)], -1).astype(np.float32)
    d = np.zeros_like(o)
    d[:24] = targets - o[:24]
    d[24:] = [0.0, 0.0, 1.0]
    d[24:, :2] += rng.uniform(5, 9, (8, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return verts, faces, o, d


def _sponza_rays():
    """Rays from inside the sponza-class atrium in all directions."""
    rng = np.random.default_rng(6)
    o = rng.uniform([1.0, 0.5, 1.0], [23.0, 9.0, 11.0], (40, 3))
    d = rng.normal(size=(40, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _case(name):
    if name == "sponza4000_K32_T256_fallback":
        verts, faces, _ = jsponza.sponza_like_mesh(4000)
        o, d = _sponza_rays()
        K, T = 32, 256
    else:
        verts, faces, o, d = _fixture48()
        K, T = {"fixture48_K16": (16, 0), "fixture48_K48": (48, 0)}[name]
    jm = JMesh.create(verts, faces)
    tm = TriangleMesh.create(verts, faces, device=CPU)
    return (jm, jbuild(jm, cluster_size=K, treelet_size=T), tm,
            build_cluster_bvh(tm, cluster_size=K, treelet_size=T), o, d)


CASES = {"fixture48_K16": 3, "fixture48_K48": 1,
         "sponza4000_K32_T256_fallback": 151}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param, _case(request.param)


def test_radix_build_tables_equal(case):
    name, (jm, jb, tm, tb, _, _) = case
    C = CASES[name]
    for k in STATICS:
        assert getattr(tb, k) == getattr(jb, k), k
    assert tb.num_clusters == C and not tb.heap and tb.treelet_size == 0
    for k in ("nodes", "tris"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)
    assert tb.nodes.shape == (2 * C - 1, 8)
    # the recorded depth is the tree's, also when read off the JAX tables
    carried = convert.cluster_bvh_from_arrays(
        {f.name: (v if f.name in STATICS or v is None else np.asarray(v))
         for f in dataclasses.fields(jb)
         for v in [getattr(jb, f.name)]}, device=CPU)
    assert carried.depth == tb.depth
    assert (tb.depth == 0) == (C == 1)


def _unique_nearest(ray, mesh):
    v1, e1, e2 = mesh.corners()
    t, _, _, hit = intersect_triangle(ray.ori[:, None], ray.dir[:, None],
                                      v1, e1, e2)
    t = torch.where(hit & (t >= 0), t, float("inf"))
    return ((t == t.min(dim=1, keepdim=True).values).sum(1) == 1).numpy()


def test_radix_closest_hit_matches_jax(case):
    name, (jm, jb, tm, tb, o, d) = case
    ray = Ray(torch.as_tensor(o), torch.as_tensor(d))
    got = trav.cluster_closest_hit(ray, tb, tm)
    ref = jtrav.cluster_closest_hit(JRay(jnp.asarray(o), jnp.asarray(d)),
                                    jb, jm, interpret=True)
    brute = intersect_triangles_brute(ray, *tm.corners(), tm.geom_ids)
    hit = np.asarray(ref.hit)
    assert hit.sum() >= 16
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.hit.numpy(), brute.hit.numpy())
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    uniq = _unique_nearest(ray, tm) & hit
    np.testing.assert_array_equal(got.prim_id.numpy()[uniq],
                                  np.asarray(ref.prim_id)[uniq])


def test_radix_any_hit_matches_jax(case):
    name, (jm, jb, tm, tb, o, d) = case
    ray = Ray(torch.as_tensor(o), torch.as_tensor(d))
    brute = intersect_triangles_brute(ray, *tm.corners(), tm.geom_ids)
    # half the hit lanes cut below their first hit
    cut = brute.hit & (torch.arange(o.shape[0]) % 2 == 0)
    mt = torch.where(cut, brute.t * 0.9, 1e30)
    got = trav.cluster_any_hit(ray, tb, tm, mt)
    ref = jtrav.cluster_any_hit(JRay(jnp.asarray(o), jnp.asarray(d)), jb,
                                jm, jnp.asarray(mt.numpy()), interpret=True)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.hit.numpy(), (brute.hit & ~cut).numpy())
    assert int(got.hit.sum()) >= 4


def test_radix_wrapper_refusals(case):
    """A radix tree starts at node 0 only, needs its depth, and fits the
    stack; it takes neither of 1f's options (wide descent needs a heap,
    the half skip needs half boxes)."""
    name, (_, _, _, tb, o, d) = case
    n = o.shape[0]
    rays = trav._pack_rays(torch.as_tensor(o), torch.as_tensor(d),
                           torch.full((n,), 1e30), n, 4096, pad_maxt=-1.0)
    args = (rays, tb.nodes, tb.tris, tb.num_clusters, tb.cluster_size, 4096)
    roots = torch.ones((2, 1), dtype=torch.int32)
    splits = torch.full((1,), 4096, dtype=torch.int32)
    with pytest.raises(ValueError, match="node 0"):
        trav.cluster_traverse(*args, heap=False, depth=tb.depth,
                              tile_roots=roots, tile_splits=splits)
    with pytest.raises(ValueError, match="node 0"):
        trav.traverse_plain(*args, False, roots, splits, heap=False)
    with pytest.raises(ValueError, match="depth"):
        trav.cluster_traverse(*args, heap=False)
    with pytest.raises(ValueError, match="stack"):
        trav.cluster_traverse(*args, heap=False,
                              depth=trav.STACK_DEPTH + 1)
    with pytest.raises(ValueError, match="heap"):
        trav.cluster_traverse(*args, heap=False, depth=tb.depth, fanout=4)
    with pytest.raises(ValueError, match="half boxes"):
        trav.cluster_traverse(*args, heap=False, depth=tb.depth,
                              half_skip=True)
    before = dict(trav.LAUNCHES)
    t, p, _, _ = trav.cluster_traverse(*args, heap=False, depth=tb.depth)
    assert trav.LAUNCHES == before, "CPU tensors never count as launches"
    assert trav.launch_mode(False, tb.num_clusters, False, False) == (
        "c1_closest" if tb.num_clusters == 1 else "radix_closest")
    assert int((p[:n] >= 0).sum()) >= 16
