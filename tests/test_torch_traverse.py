"""ClusterBVH traversal: the port's plain PyTorch version (what the kernel
wrapper runs on CPU tensors) and glue vs the JAX package's Pallas kernel in
interpret mode, on the fixtures of test_pallas_traverse.py and
test_binned_traversal.py with the JAX-built BVH carried over by convert.py.

Tolerances: ``hit`` equal; ``t`` within rtol 1e-5 (XLA and torch round the
same formula differently in the last ulp); ``prim`` only where the nearest
hit is unique, since the strict t < best_t fold lets traversal order decide
ties.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh
from visionaray_tpu.scenes import random_triangles

from visionaray_torch import convert
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.trace import intersect_triangles_brute

torch.set_num_threads(1)
CPU = "cpu"
STATICS = ("num_clusters", "cluster_size", "treelet_size", "num_treelets",
           "heap", "half_boxes")


def _carry(jmesh, jbvh):
    mesh = convert.mesh_from_arrays(
        {f.name: (getattr(jmesh, f.name) if f.name == "face_normals_binding"
                  else np.asarray(getattr(jmesh, f.name)))
         for f in dataclasses.fields(jmesh)}, device=CPU)
    bvh = convert.cluster_bvh_from_arrays(
        {f.name: (getattr(jbvh, f.name) if f.name in STATICS
                  else np.asarray(getattr(jbvh, f.name)))
         for f in dataclasses.fields(jbvh)}, device=CPU)
    return mesh, bvh


def _fixture(verts, faces, o, d, K, T):
    jmesh = JMesh.create(verts, faces)
    jbvh = build_cluster_bvh(jmesh, cluster_size=K, treelet_size=T)
    mesh, bvh = _carry(jmesh, jbvh)
    return dict(jmesh=jmesh, jbvh=jbvh, jray=JRay(jnp.asarray(o),
                                                   jnp.asarray(d)),
                mesh=mesh, bvh=bvh, ray=Ray(torch.as_tensor(o),
                                            torch.as_tensor(d)))


@pytest.fixture(scope="module")
def coherent():
    """test_pallas_traverse.py's geometry and rays, on a heap build."""
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
    return _fixture(verts, faces, o, d, K=8, T=2)


@pytest.fixture(scope="module")
def binned():
    """test_binned_traversal.py's geometry, rays and build (K=8, T=4)."""
    verts, faces = random_triangles(96, seed=7, extent=3.0, tri_size=0.8)
    rng = np.random.default_rng(3)
    n = 40
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    cent = verts.reshape(-1, 3, 3).mean(axis=1)
    d = (cent[rng.integers(0, len(cent), n)] - o).astype(np.float32)
    d[32:] = rng.normal(size=(n - 32, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return _fixture(verts, faces, o, d, K=8, T=4)


def _unique_nearest(rays, bvh):
    """Lanes whose nearest triangle (over the whole table) is unique."""
    rec = bvh.tri_records().reshape(-1, 16)
    t, _, _, ok = trav._mt(rays[:, 0:3], rays[:, 3:6], rec)
    t = torch.where(ok & (t >= 0), t, float("inf"))
    return (t == t.min(dim=1, keepdim=True).values).sum(1) == 1


def _compare(got, ref, rays, bvh, any_hit):
    """got/ref: (t, prim, u, v) per lane, torch and numpy."""
    mt = rays[:, 6].numpy()
    live = mt >= 0
    gt, gp = got[0].numpy(), got[1].numpy()
    rt, rp = np.asarray(ref[0]).reshape(-1), np.asarray(ref[1]).reshape(-1)
    # Lanes whose hit lies at max_t to within the rounding: in a binned
    # round after the first, a pass-B lane that starts at an ancestor of its
    # treelet finds its previous best triangle again at t ~ max_t (= the
    # previous best minus the entry), and the last ulp decides t < max_t.
    # The round's result is the same either way (global-t min).
    def at_cap(t, p):
        return (p >= 0) & (np.abs(t - mt) <= 1e-5 * np.abs(mt))

    edge = at_cap(gt, gp) | at_cap(rt, rp)
    compared = int((live & ~edge).sum())
    np.testing.assert_array_equal((gp >= 0)[~edge], (rp >= 0)[~edge])
    miss = (gp < 0) & (rp < 0)
    np.testing.assert_array_equal(gt[miss], rt[miss])   # t = max_t
    np.testing.assert_array_equal(gt[miss], mt[miss])
    assert (gp[~live] == -1).all()
    if any_hit:
        return compared, int((gp >= 0).sum())
    hit = (gp >= 0) & (rp >= 0)
    np.testing.assert_allclose(gt[hit], rt[hit], rtol=1e-5)
    uniq = _unique_nearest(rays, bvh).numpy() & hit
    np.testing.assert_array_equal(gp[uniq], rp[uniq])
    # barycentrics: the dot products of b1/b2 cancel (rays aimed at
    # centroids), so a last-ulp rounding difference grows to ~4e-5
    for c in (2, 3):
        np.testing.assert_allclose(got[c].numpy()[uniq],
                                   np.asarray(ref[c]).reshape(-1)[uniq],
                                   atol=1e-4)
    return compared, int(hit.sum())


def _jax_kernel(rays, bvh, jbvh, tile_rows, any_hit, roots=None,
                splits=None):
    """The Pallas kernel (interpret mode) on the port's packed lanes."""
    npad = rays.shape[0]
    n_groups = npad // (tile_rows * 128 * jtrav.INTERLEAVE)
    rays8 = jnp.asarray(rays.numpy().T.reshape(
        8, n_groups, jtrav.INTERLEAVE, tile_rows, 128))
    kw = {}
    if roots is not None:
        kw = dict(tile_roots=jnp.asarray(roots.numpy()).reshape(
                      2, n_groups, jtrav.INTERLEAVE),
                  tile_splits=jnp.asarray(splits.numpy()).reshape(
                      n_groups, jtrav.INTERLEAVE))
    return jtrav._cluster_traverse(
        rays8, jbvh.nodes, jbvh.tris, bvh.num_clusters, bvh.cluster_size,
        any_hit=any_hit, interpret=True, heap=True, **kw)


@pytest.mark.parametrize("any_hit", [False, True], ids=["1", "1d"])
def test_plain_vs_pallas_coherent(coherent, any_hit):
    """Modes 1 (closest) and 1d (any-hit): every lane starts at the root."""
    f = coherent
    o, d = f["ray"].ori, f["ray"].dir
    n = o.shape[0]
    ref = intersect_triangles_brute(f["ray"], *f["mesh"].corners(),
                                    f["mesh"].geom_ids)
    mt = torch.full((n,), 1e30)
    if any_hit:   # a third cut below the first hit, a third dead
        mt = torch.where(ref.hit & (torch.arange(n) % 3 == 1),
                         ref.t * 0.9, mt)
    mt[torch.arange(n) % 3 == 2] = -1.0
    rays = trav._pack_rays(o, d, mt, n, 8192, pad_maxt=-1.0)
    got = trav.cluster_traverse(rays, f["bvh"].nodes, f["bvh"].tris,
                                f["bvh"].num_clusters,
                                f["bvh"].cluster_size,
                                tile_lanes=trav.TILE_ROWS * 128,
                                any_hit=any_hit)
    jref = _jax_kernel(rays, f["bvh"], f["jbvh"], jtrav.TILE_ROWS, any_hit)
    compared, hits = _compare(got, jref, rays, f["bvh"], any_hit)
    assert compared >= 20 and hits >= 4


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, rays, *args, **kw):
        self.calls.append((rays.clone(), dict(kw)))
        return trav.traverse_plain(
            rays, *args[:4], kw["tile_lanes"] if "tile_lanes" in kw
            else args[4], kw.get("any_hit", False), kw["tile_roots"],
            kw["tile_splits"])


@pytest.mark.parametrize("any_hit", [False, True], ids=["1b", "1c"])
def test_plain_vs_pallas_binned_rounds(binned, any_hit, monkeypatch):
    """Modes 1b/1c: the lanes, roots and splits of real binned rounds."""
    f = binned
    rec = _Recorder()
    monkeypatch.setattr(trav, "cluster_traverse", rec)
    mt = torch.full((f["ray"].ori.shape[0],), 1e30)
    trav._binned_trace(f["ray"], f["bvh"], mt, 4, any_hit=any_hit)
    monkeypatch.undo()
    assert len(rec.calls) >= 2
    straddle = compared = 0
    for rays, kw in rec.calls[:2]:
        roots, splits = kw["tile_roots"], kw["tile_splits"]
        straddle += int((splits < trav.BINNED_ROWS * 128).sum())
        got = trav.cluster_traverse(
            rays, f["bvh"].nodes, f["bvh"].tris, f["bvh"].num_clusters,
            f["bvh"].cluster_size, tile_lanes=trav.BINNED_ROWS * 128,
            any_hit=any_hit, tile_roots=roots, tile_splits=splits)
        jref = _jax_kernel(rays, f["bvh"], f["jbvh"], trav.BINNED_ROWS,
                           any_hit, roots, splits)
        compared += _compare(got, jref, rays, f["bvh"], any_hit)[0]
        assert (rays[:, 6] < 0).any(), "rounds carry dead lanes"
    assert straddle >= 1, "a two-pass tile must be exercised"
    assert compared >= 30, "too few lanes left to compare"


def _record_pair(got, ref, brute=None):
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(got.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    if brute is not None:
        np.testing.assert_array_equal(got.hit.numpy(), brute.hit.numpy())
        np.testing.assert_array_equal(got.prim_id.numpy()[m],
                                      brute.prim_id.numpy()[m])
        np.testing.assert_array_equal(got.geom_id.numpy(),
                                      np.asarray(ref.geom_id))


FRONT_ENDS = {
    "cluster_closest_hit": lambda f, jf, mt: (
        trav.cluster_closest_hit(f["ray"], f["bvh"], f["mesh"]),
        jtrav.cluster_closest_hit(jf["jray"], jf["jbvh"], jf["jmesh"],
                                  interpret=True)),
    "cluster_closest_hit_two_pass": lambda f, jf, mt: (
        trav.cluster_closest_hit(f["ray"], f["bvh"], f["mesh"],
                                 two_pass=True),
        jtrav.cluster_closest_hit(jf["jray"], jf["jbvh"], jf["jmesh"],
                                  interpret=True, two_pass=True)),
    "binned_closest_hit_m4": lambda f, jf, mt: (
        trav.binned_closest_hit(f["ray"], f["bvh"], f["mesh"], m=4),
        jtrav.binned_closest_hit(jf["jray"], jf["jbvh"], jf["jmesh"],
                                 interpret=True, m=4)),
    "binned_closest_hit_m2_overflow": lambda f, jf, mt: (
        trav.binned_closest_hit(f["ray"], f["bvh"], f["mesh"], m=2),
        jtrav.binned_closest_hit(jf["jray"], jf["jbvh"], jf["jmesh"],
                                 interpret=True, m=2)),
    "binned_any_hit": lambda f, jf, mt: (
        trav.binned_any_hit(f["ray"], f["bvh"], f["mesh"],
                            torch.as_tensor(mt), m=3),
        jtrav.binned_any_hit(jf["jray"], jf["jbvh"], jf["jmesh"],
                             jnp.asarray(mt), interpret=True, m=3)),
    "cluster_any_hit": lambda f, jf, mt: (
        trav.cluster_any_hit(f["ray"], f["bvh"], f["mesh"],
                             torch.as_tensor(mt)),
        jtrav.cluster_any_hit(jf["jray"], jf["jbvh"], jf["jmesh"],
                              jnp.asarray(mt), interpret=True)),
}


@pytest.mark.parametrize("name", sorted(FRONT_ENDS))
def test_front_ends_match_jax_and_brute(binned, name):
    f = binned
    brute = intersect_triangles_brute(f["ray"], *f["mesh"].corners(),
                                      f["mesh"].geom_ids)
    assert int(brute.hit.sum()) >= 10
    # any-hit: half the hit lanes cut below their first hit
    cut = brute.hit & (torch.arange(brute.hit.shape[0]) % 2 == 0)
    mt = torch.where(cut, brute.t * 0.9, 1e30).numpy()
    got, ref = FRONT_ENDS[name](f, f, mt)
    if "any" in name:
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(got.hit.numpy(),
                                      (brute.hit & ~cut).numpy())
    else:
        _record_pair(got, ref, brute)


def test_treelet_entries_equal(binned):
    f = binned
    rng = np.random.default_rng(9)
    o = rng.uniform(-3, 3, (600, 3)).astype(np.float32)
    d = rng.normal(size=(600, 3)).astype(np.float32)
    d[:20, 0] = 0.0           # axis-parallel: exercises the 1/d clamp
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mt = np.where(rng.random(600) < 0.2, 1.5, 1e30).astype(np.float32)
    bvh, jbvh = f["bvh"], f["jbvh"]
    for m in (2, 4):
        ent, slot = trav._treelet_entries(
            torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mt),
            bvh.treelet_lo, bvh.treelet_hi, m)
        jent, jslot = jtrav._treelet_entries(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt),
            jbvh.treelet_lo, jbvh.treelet_hi, m)
        np.testing.assert_array_equal(ent.numpy(), np.asarray(jent))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        assert torch.isinf(ent).any()
        assert (slot[:, -1] == -1).any() == (m < bvh.num_treelets)


META_CASES = [
    [[0] * 8], [[0, 0, 0, 1, 1, 1, 1, 1]], [[1, 1, 2, 2, 3, 3, 3, 3]],
    [[0, 0, 0, 0, 4, 4, 5, 5]], [[0, 0, 1, 1, 5, 5, 5, 5]], [[4] * 8],
    [[0, 0, 0, 0, 0, 0, 1, 1], [1, 1, 1, 1, 2, 2, 2, 2]],
    [[0] * 8, [5] * 8],
]


@pytest.mark.parametrize("case", range(len(META_CASES) + 1))
def test_two_pass_tile_meta_equal(case):
    S, chunk = 4, 8
    if case < len(META_CASES):
        keys = np.concatenate(META_CASES[case]).astype(np.int32)
    else:   # random sorted keys over 16 tiles
        keys = np.sort(np.random.default_rng(case).integers(
            0, S + 2, 16 * chunk)).astype(np.int32)
    troots = np.arange(S, dtype=np.int32) + (S - 1)
    npad = keys.shape[0]
    got = trav._two_pass_tile_meta(torch.as_tensor(keys),
                                   torch.as_tensor(troots), S, npad // chunk,
                                   chunk, 3, npad)
    ref = jtrav._two_pass_tile_meta(jnp.asarray(keys), jnp.asarray(troots),
                                    S, npad // chunk, chunk, 3, npad)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coherence_perm_equal():
    rng = np.random.default_rng(4)
    n = 20000
    o = np.repeat(rng.uniform(-1, 1, (50, 3)), n // 50, 0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    lo = np.array([-1.5, -1, -2], np.float32)
    hi = np.array([1, 2, 1.5], np.float32)
    perm, inv = trav._coherence_perm(torch.as_tensor(o), torch.as_tensor(d),
                                     torch.as_tensor(lo), torch.as_tensor(hi))
    jperm, jinv = jtrav._coherence_perm(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_wrapper_runs_plain_on_cpu_and_checks(coherent):
    f = coherent
    bvh = f["bvh"]
    n = f["ray"].ori.shape[0]
    rays = trav._pack_rays(f["ray"].ori, f["ray"].dir, torch.full((n,), 1e30),
                           n, 4096, pad_maxt=-1.0)
    before = dict(trav.LAUNCHES)
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                bvh.cluster_size, tile_lanes=4096)
    roots, splits = trav._default_tiles(4096, 4096, "cpu")
    plain = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                bvh.cluster_size, 4096, False, roots, splits)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert trav.LAUNCHES == before, "CPU tensors never count as launches"
    with pytest.raises(ValueError, match="rays"):
        trav.cluster_traverse(rays[:, :7].contiguous(), bvh.nodes, bvh.tris,
                              bvh.num_clusters, bvh.cluster_size, 4096)
    with pytest.raises(ValueError, match="multiple"):
        trav.cluster_traverse(rays[:100], bvh.nodes, bvh.tris,
                              bvh.num_clusters, bvh.cluster_size, 4096)
    with pytest.raises(ValueError, match="contiguous"):
        trav.cluster_traverse(rays, bvh.nodes.t().contiguous().t(),
                              bvh.tris, bvh.num_clusters, bvh.cluster_size,
                              4096)


def test_plain_confines_lanes_to_their_subtree(binned):
    """A lane that starts at a treelet root sees only that treelet."""
    f = binned
    bvh = f["bvh"]
    brute = intersect_triangles_brute(f["ray"], *f["mesh"].corners(),
                                      f["mesh"].geom_ids)
    n = f["ray"].ori.shape[0]
    rays = trav._pack_rays(f["ray"].ori, f["ray"].dir, torch.full((n,), 1e30),
                           n, 2048, pad_maxt=-1.0)
    S = bvh.num_treelets
    hits_any = torch.zeros(2048, dtype=torch.bool)
    for s in range(S):
        root = int(bvh.treelet_roots[s])
        t, p, _, _ = trav.traverse_plain(
            rays, bvh.nodes, bvh.tris, bvh.num_clusters, bvh.cluster_size,
            2048, False, torch.tensor([[root], [root]], dtype=torch.int32),
            torch.tensor([2048], dtype=torch.int32))
        recs = bvh.tri_records()[s * bvh.treelet_size:
                                 (s + 1) * bvh.treelet_size, :, 9]
        own = set(recs.reshape(-1).tolist())
        assert set(p[p >= 0].tolist()) <= own
        hits_any |= p >= 0
    np.testing.assert_array_equal(hits_any[:n].numpy(), brute.hit.numpy())
