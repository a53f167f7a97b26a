"""The Python around the two-pass kernel (ops/cuda/traverse_binned.cu) on
the CPU: its stack, the cluster sizes it takes, the entry point and launch
keys of each form, and the binned front ends still equal to the JAX
package's (interpret mode) on test_binned_traversal.py's fixture, with
test_torch_traverse.py's tolerances, in cases the existing front-end test
does not run, among them a build at K=40, the automatic cluster size of a
~430k-triangle mesh.  The kernel itself is held against the plain version
on the card by tests/test_torch_cuda_traverse.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_traverse import _carry, _record_pair, binned  # noqa: F401
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import pick_cluster_size
from visionaray_torch.ops.trace import intersect_triangles_brute

torch.set_num_threads(1)
TL = trav.BINNED_ROWS * 128


def _heap_tables(C, K):
    """Uninitialised tables of a heap tree with C clusters of K records
    (the checks read shapes only) and one tile of dead lanes."""
    nodes = torch.empty((2 * C - 1, 8))
    tris = torch.empty((C, K // 8, 128))
    rays = trav._pack_rays(torch.zeros(1, 3), torch.ones(1, 3),
                           torch.full((1,), -1.0), 1, TL, pad_maxt=-1.0)
    roots = torch.zeros((2, 1), dtype=torch.int32)
    splits = torch.full((1,), TL, dtype=torch.int32)
    return rays, nodes, tris, roots, splits


def test_binned_stack_depth():
    """Two-pass tiles share the coherent kernel's STACK_DEPTH-entry stack:
    a heap of depth 17 runs at every fanout on both tile layouts."""
    C = 1 << 17
    rays, nodes, tris, roots, splits = _heap_tables(C, 8)
    for fanout in trav.FANOUTS:
        assert trav.stack_need(17, fanout) <= trav.STACK_DEPTH
        for tiles in ({}, dict(tile_roots=roots, tile_splits=splits)):
            t, p, _, _ = trav.cluster_traverse(rays, nodes, tris, C, 8, TL,
                                               fanout=fanout, **tiles)
            assert torch.equal(t, rays[:, 6])
            assert torch.equal(p, torch.full((TL,), -1.0))


@pytest.mark.parametrize("K", [24, 40])
def test_binned_takes_any_multiple_of_8(K):
    """Two-pass tiles take every K the builds make: the kernel unrolls
    BINNED_K and runs the rest (pick_cluster_size gives 40, 48, ... on large
    meshes) through its run-time-K form.  A K that is no multiple of 8 is
    refused on both layouts."""
    rays, nodes, tris, roots, splits = _heap_tables(2, K)
    for tiles in ({}, dict(tile_roots=roots, tile_splits=splits)):
        t, _, _, _ = trav.cluster_traverse(rays, nodes, tris, 2, K, TL,
                                           **tiles)
        assert torch.equal(t, rays[:, 6])
        with pytest.raises(ValueError, match="multiple of 8"):
            trav.cluster_traverse(rays, nodes, tris[:, :1].contiguous(), 2,
                                  12, TL, **tiles)


@pytest.mark.parametrize("fanout,half_skip",
                         [(f, h) for f in trav.FANOUTS for h in (False,
                                                                 True)])
def test_launch_form_keys(fanout, half_skip):
    """Two-pass tiles go to traverse_binned.cu's entry point, coherent tiles
    on a heap tree to traverse_coherent.cu's at binary descent without the
    half skip and K in BINNED_K, and to traverse_binned.cu's otherwise;
    radix trees (C == 1 too) to traverse_binned.cu's at every K.
    LAUNCHES and VARIANT_LAUNCHES keep their keys per mode and per
    (fanout, half_skip)."""
    suffix = f"/fanout{fanout}" + ("/half_skip" if half_skip else "")
    for any_hit, kind in ((False, "closest"), (True, "any")):
        for K in (*trav.BINNED_K, 40):
            assert trav.launch_form(True, 8192, True, any_hit, fanout,
                                    half_skip, K) == (
                "vsnray_traverse_binned", f"binned_{kind}",
                f"binned_{kind}" + suffix)
            coherent = (fanout == 2 and not half_skip
                        and K in trav.BINNED_K)
            assert trav.launch_form(True, 8192, False, any_hit, fanout,
                                    half_skip, K) == (
                "vsnray_traverse_coherent" if coherent
                else "vsnray_traverse_binned", kind, kind + suffix)
    assert trav.launch_form(False, 1, False, True, 2, False, 32)[:2] == (
        "vsnray_traverse_binned", "c1_any")
    assert trav.launch_form(False, 8115, False, False, 2, False, 40)[:2] == (
        "vsnray_traverse_binned", "radix_closest")
    assert set(trav.LAUNCHES) >= {"binned_closest", "binned_any"}


# front-end cases beside test_torch_traverse.py's (closest m=4 and m=2,
# any-hit m=3, all at K=8): closest-hit at m=3, and any-hit at the main
# path's shadow_m=6 switch (m is clamped to the fixture's 4 treelets on both
# sides); then both at K=40 with one cluster a treelet, the run-time-K form
# on the card (any-hit there against the brute force only: the JAX
# package's interpret mode takes ~25 s a call at K=40).  name: (any_hit, m,
# K)
K_AUTO = pick_cluster_size(430_000)
CASES = {"binned_closest_hit_m3": (False, 3, 8),
         "binned_any_hit_m6": (True, 6, 8),
         "binned_closest_hit_k40": (False, 4, K_AUTO),
         "binned_any_hit_k40": (True, 3, K_AUTO)}


@pytest.fixture(scope="module")
def binned_k40(binned):  # noqa: F811
    """The binned fixture's mesh and rays on a treelet build at K=40, T=1
    (4 clusters, each its own treelet), built by the JAX package and
    carried over."""
    jbvh = build_cluster_bvh(binned["jmesh"], cluster_size=K_AUTO,
                             treelet_size=1)
    mesh, bvh = _carry(binned["jmesh"], jbvh)
    assert bvh.cluster_size == 40 and bvh.num_treelets == 4
    return dict(binned, jbvh=jbvh, mesh=mesh, bvh=bvh)


@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_front_end_matches_jax(request, name):
    any_hit, m, K = CASES[name]
    f = request.getfixturevalue("binned_k40" if K == K_AUTO else "binned")
    brute = intersect_triangles_brute(f["ray"], *f["mesh"].corners(),
                                      f["mesh"].geom_ids)
    n = brute.hit.shape[0]
    if any_hit:   # half the hit lanes cut below their first hit
        cut = brute.hit & (torch.arange(n) % 2 == 0)
        mt = torch.where(cut, brute.t * 0.9, 1e30).numpy()
        got = trav.binned_any_hit(f["ray"], f["bvh"], f["mesh"],
                                  torch.as_tensor(mt), m=m)
        if K != K_AUTO:
            ref = jtrav.binned_any_hit(f["jray"], f["jbvh"], f["jmesh"],
                                       jnp.asarray(mt), interpret=True, m=m)
            np.testing.assert_array_equal(got.hit.numpy(),
                                          np.asarray(ref.hit))
        np.testing.assert_array_equal(got.hit.numpy(),
                                      (brute.hit & ~cut).numpy())
    else:
        got = trav.binned_closest_hit(f["ray"], f["bvh"], f["mesh"], m=m)
        ref = jtrav.binned_closest_hit(f["jray"], f["jbvh"], f["jmesh"],
                                       interpret=True, m=m)
        _record_pair(got, ref, brute)
    assert int(got.hit.sum()) >= 10
