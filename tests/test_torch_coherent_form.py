"""The Python around the coherent kernel (ops/cuda/traverse_coherent.cu) on
the CPU: the entry point each launch form goes to (radix trees and C == 1
included), that every entry takes the forms sent to it and that no form
the wrapper took before is refused now, the library's sources, the
coherent front ends still equal to the JAX package's (interpret mode) with
test_torch_traverse.py's tolerances, and the plain walk that
scripts/torch_coherence.py reads the coherence from, on heap and radix
trees.  The kernel itself is held against the plain version on the card
by tests/test_torch_cuda_traverse.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.torch_coherence import walk_plain
from test_torch_traverse import _fixture, _record_pair
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.scenes import random_triangles
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.trace import intersect_triangles_brute

torch.set_num_threads(1)
KS = (8, 16, 24, 32, 40)   # the unrolled sizes, and two run-time-K ones
ENTRIES = ("vsnray_traverse_binned", "vsnray_traverse_coherent",
           "vsnray_traverse_lbvh", "vsnray_volume_march",
           "vsnray_volume_march_bwd")


def _takes(entry, heap, two_pass, fanout, half_skip, K):
    """Whether the C entry point launches this form (its own switch over
    the forms it was compiled in; cudaErrorInvalidValue otherwise)."""
    if entry == "vsnray_traverse_coherent":
        return (heap and not two_pass and fanout == 2 and not half_skip
                and K in trav.BINNED_K)
    if not heap:     # radix trees: lane_walk, binary descent, no half skip
        return K > 0 and K % 8 == 0 and fanout == 2 and not half_skip
    return (K > 0 and K % 8 == 0 and fanout in trav.FANOUTS
            and (not half_skip or K >= 16))


def _accepted(heap, two_pass, fanout, half_skip, K):
    """The forms cluster_traverse's checks let through (unchanged by the
    coherent kernel)."""
    return (K % 8 == 0 and (heap or fanout == 2)
            and (not half_skip or (heap and K >= 16))
            and not (two_pass and not heap))


FORMS = [(h, tp, f, hs) for h in (True, False) for tp in (False, True)
         for f in trav.FANOUTS for hs in (False, True)]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("K", KS)
def test_launch_form_entry(K, any_hit):
    """Every (heap, two_pass, fanout, half_skip) at this K and any_hit: the
    entry point, the LAUNCHES and VARIANT_LAUNCHES keys, and that the entry
    takes every form the wrapper accepts."""
    kind = "any" if any_hit else "closest"
    for heap, two_pass, fanout, half_skip in FORMS:
        C = 8192 if heap else 8115
        entry, mode, key = trav.launch_form(heap, C, two_pass, any_hit,
                                            fanout, half_skip, K)
        if two_pass or not heap:
            want = "vsnray_traverse_binned"
        elif fanout == 2 and not half_skip and K in (8, 16, 32):
            want = "vsnray_traverse_coherent"
        else:
            want = "vsnray_traverse_binned"
        assert entry == want
        assert mode == trav.launch_mode(heap, C, two_pass, any_hit)
        assert mode == (("binned_" if two_pass else "") + kind if heap
                        else "radix_" + kind)
        assert key == trav.variant_key(mode, fanout, half_skip)
        if _accepted(heap, two_pass, fanout, half_skip, K):
            assert _takes(entry, heap, two_pass, fanout, half_skip, K)
    assert trav.launch_form(False, 1, False, any_hit, 2, False, K)[:2] == (
        "vsnray_traverse_binned", "c1_" + kind)


def test_sources_and_counts():
    """The library is built from the five kernel sources, each holding
    one entry point, and no other source sits beside them (radix trees run
    traverse_binned.cu's lane walk; the LBVH tier's flat trees
    traverse_lbvh.cu; the volume renderer volume_march.cu and its
    backward volume_march_bwd.cu);
    ENTRY_LAUNCHES counts per entry point and resets with the other
    counts."""
    names = sorted(p.name for p in trav.SOURCES)
    assert names == ["traverse_binned.cu", "traverse_coherent.cu",
                     "traverse_lbvh.cu", "volume_march.cu",
                     "volume_march_bwd.cu"]
    assert sorted(p.name for p in trav._CUDA_DIR.glob("*.cu")) == names
    for src in trav.SOURCES:
        text = src.read_text()
        assert [e for e in ENTRIES if f'extern "C" int {e}(' in text] == [
            {"traverse_binned.cu": "vsnray_traverse_binned",
             "traverse_coherent.cu": "vsnray_traverse_coherent",
             "traverse_lbvh.cu": "vsnray_traverse_lbvh",
             "volume_march.cu": "vsnray_volume_march",
             "volume_march_bwd.cu": "vsnray_volume_march_bwd"}[src.name]]
    assert set(trav.ENTRY_LAUNCHES) == set(ENTRIES)
    trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"] += 1
    trav.reset_launch_counts()
    assert not any(trav.ENTRY_LAUNCHES.values())


@pytest.mark.parametrize("K", KS)
def test_coherent_forms_not_refused(K):
    """Every coherent heap form the wrapper took before the coherent kernel
    (fanout 2, 4, 8, with the half skip at K >= 16, any multiple of 8)
    still runs, on CPU tensors through the plain version, and its entry
    point takes it."""
    C, TL = 4, trav.TILE_ROWS * 128
    nodes = torch.empty((2 * C - 1, 8))
    tris = torch.empty((C, K // 8, 128))
    rays = trav._pack_rays(torch.zeros(1, 3), torch.ones(1, 3),
                           torch.full((1,), -1.0), 1, TL, pad_maxt=-1.0)
    for fanout in trav.FANOUTS:
        for half_skip in (False, True) if K >= 16 else (False,):
            for any_hit in (False, True):
                entry = trav.launch_form(True, C, False, any_hit, fanout,
                                         half_skip, K)[0]
                assert _takes(entry, True, False, fanout, half_skip, K)
                t, p, _, _ = trav.cluster_traverse(
                    rays, nodes, tris, C, K, TL, any_hit=any_hit,
                    fanout=fanout, half_skip=half_skip)
                assert torch.equal(t, rays[:, 6])
                assert torch.equal(p, torch.full((TL,), -1.0))


@pytest.fixture(scope="module")
def fan():
    """test_pallas_traverse.py's geometry (48 triangles, K=8, T=2) seen by
    a pinhole fan: 256 rays from one point to a 16 x 16 grid, row by row,
    the lanes of a coherent launch."""
    verts, faces = random_triangles(48, seed=5, extent=3.0, tri_size=1.0)
    g = (np.arange(16, dtype=np.float32) + 0.5) / 16 * 3.0 - 1.5
    gy, gx = np.meshgrid(g, g, indexing="ij")
    targets = np.stack([gx.ravel(), gy.ravel(), np.zeros(256)], -1)
    o = np.tile(np.array([[0.3, -0.2, -9.0]], np.float32), (256, 1))
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return _fixture(verts, faces, o, d, K=8, T=2)


FRONT_ENDS = {   # name: (port front end, JAX front end), max_t for any-hit
    "closest": (
        lambda f, mt: trav.cluster_closest_hit(f["ray"], f["bvh"],
                                               f["mesh"]),
        lambda f, mt: jtrav.cluster_closest_hit(
            f["jray"], f["jbvh"], f["jmesh"], interpret=True)),
    "closest_two_pass": (
        lambda f, mt: trav.cluster_closest_hit(f["ray"], f["bvh"], f["mesh"],
                                               two_pass=True),
        lambda f, mt: jtrav.cluster_closest_hit(
            f["jray"], f["jbvh"], f["jmesh"], interpret=True,
            two_pass=True)),
    "any": (
        lambda f, mt: trav.cluster_any_hit(f["ray"], f["bvh"], f["mesh"],
                                           torch.as_tensor(mt)),
        lambda f, mt: jtrav.cluster_any_hit(
            f["jray"], f["jbvh"], f["jmesh"], jnp.asarray(mt),
            interpret=True)),
}


@pytest.mark.parametrize("name", sorted(FRONT_ENDS))
def test_coherent_front_ends_match_jax(fan, name):
    """The coherent front ends on a pinhole fan at K=8, against the JAX
    package's (interpret mode) and brute force."""
    f = fan
    brute = intersect_triangles_brute(f["ray"], *f["mesh"].corners(),
                                      f["mesh"].geom_ids)
    assert int(brute.hit.sum()) >= 16
    # any-hit: half the hit lanes cut below their first hit
    cut = brute.hit & (torch.arange(brute.hit.shape[0]) % 2 == 0)
    mt = torch.where(cut, brute.t * 0.9, 1e30).numpy()
    port, jax_fn = FRONT_ENDS[name]
    got, ref = port(f, mt), jax_fn(f, mt)
    if name == "any":
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(got.hit.numpy(),
                                      (brute.hit & ~cut).numpy())
    else:
        _record_pair(got, ref, brute)


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_plain_matches_plain(fan, any_hit):
    """scripts/torch_coherence.py's plain walk returns traverse_plain's
    closest-hit t and any-hit flags, and visits each lane's clusters at
    most once."""
    f = fan
    bvh = f["bvh"]
    n = f["ray"].ori.shape[0]
    mt = torch.full((n,), 1e30)
    mt[::5] = -1.0
    rays = trav._pack_rays(f["ray"].ori, f["ray"].dir, mt, n, n,
                           pad_maxt=-1.0)
    t, p, visits = walk_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              bvh.cluster_size, any_hit)
    roots, splits = trav._default_tiles(n, n, "cpu")
    pt, pp, _, _ = trav.traverse_plain(rays, bvh.nodes, bvh.tris,
                                       bvh.num_clusters, bvh.cluster_size,
                                       n, any_hit, roots, splits)
    assert torch.equal(p >= 0, pp >= 0)
    if not any_hit:
        assert torch.equal(t, pt)
    assert int((pp >= 0).sum()) >= 16
    assert bool((rays[visits[:, 0], 6] >= 0).all())
    pairs = visits[:, 0] * bvh.num_clusters + visits[:, 1]
    assert torch.unique(pairs).numel() == pairs.numel()


def _radix_case(kind):
    """The fan fixture's geometry as one radix tree at K=8 (C=6, depth 3),
    or 24 seeded random triangles in one cluster (K=32, C == 1), with a
    pinhole fan of 256 rays toward it."""
    if kind == "k8":
        verts, faces = random_triangles(48, seed=5, extent=3.0,
                                        tri_size=1.0)
        K, eye = 8, [0.3, -0.2, -9.0]
    else:
        rng = np.random.default_rng(3)
        verts = rng.uniform(-1, 1, (72, 3)).astype(np.float32)
        faces = np.arange(72, dtype=np.int32).reshape(24, 3)
        K, eye = 32, [0.0, 0.5, 4.0]
    mesh = TriangleMesh.create(verts, faces, device="cpu")
    bvh = build_cluster_bvh(mesh, cluster_size=K)
    g = (np.arange(16, dtype=np.float32) + 0.5) / 16 * 2.4 - 1.2
    gy, gx = np.meshgrid(g, g, indexing="ij")
    center = verts.reshape(-1, 3).mean(0)
    targets = center + np.stack([gx.ravel(), gy.ravel(), np.zeros(256)], -1)
    o = np.tile(np.asarray([eye], np.float32), (256, 1))
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return bvh, torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["k8", "c1"])
def test_walk_plain_matches_plain_radix(kind, any_hit):
    """scripts/torch_coherence.py's plain walk on a radix tree (children
    from the kids columns) and on a single-cluster tree returns
    traverse_plain's closest-hit t and any-hit flags on every lane."""
    bvh, o, d = _radix_case(kind)
    assert not bvh.heap and (bvh.num_clusters == 1) == (kind == "c1")
    assert kind == "c1" or bvh.depth > 1
    n = o.shape[0]
    mt = torch.full((n,), 1e30)
    mt[::5] = -1.0
    rays = trav._pack_rays(o, d, mt, n, n, pad_maxt=-1.0)
    t, p, visits = walk_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              bvh.cluster_size, any_hit, heap=False,
                              depth=bvh.depth)
    roots, splits = trav._default_tiles(n, n, "cpu")
    pt, pp, _, _ = trav.traverse_plain(rays, bvh.nodes, bvh.tris,
                                       bvh.num_clusters, bvh.cluster_size,
                                       n, any_hit, roots, splits, heap=False)
    assert torch.equal(p >= 0, pp >= 0)
    if not any_hit:
        assert torch.equal(t, pt)
    assert int((pp >= 0).sum()) >= 16
    pairs = visits[:, 0] * bvh.num_clusters + visits[:, 1]
    assert torch.unique(pairs).numel() == pairs.numel()
