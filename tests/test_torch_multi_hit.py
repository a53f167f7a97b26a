"""The port's ``multi_hit`` (the k nearest hits per ray, sorted by t)
against the JAX package on the CPU, on the pattern of
tests/test_multi_hit_bvh.py.

Five stacked quads at z = 1..5, each a 4x4 grid of cells (160 triangles),
with rays at seeded random points, one ray from behind and one that
misses.  Held: ``hit``, ``prim_id`` and ``geom_id`` equal, t to rtol 1e-6,
on every tier: the ClusterBVH (K=8) as a kd heap (treelet_size=4) and as a
radix tree (treelet_size=0), k re-traces each (on the CPU the traversal
wrapper's plain version; JAX's Pallas kernel in interpret mode), and the
brute-force sweep with spheres and planes merged in.  Also: k truncation
(k=3 keeps the three nearest), padding when k exceeds the candidates, ties
broken towards the lower prim id as ``lax.top_k`` does (the port sorts
stably), and the vertex gradient of the k hits' t against ``jax.grad``
(relative L2 <= 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import Planes as JPlanes
from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.core.scene import Spheres as JSpheres
from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops import trace as jtrace
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.shading.materials import Materials as JMaterials

from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.core.types import FLT_MAX, Ray
from visionaray_torch.ops import trace as ttrace
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.shading.materials import Materials

torch.set_num_threads(1)
CPU = "cpu"
CELLS = 4


def _stacked_quads(n):
    verts, faces, gids = [], [], []
    g = np.linspace(-1.0, 1.0, CELLS + 1)
    for i in range(n):
        base = len(verts)
        verts += [[x, y, 1.0 + i] for y in g for x in g]
        for r in range(CELLS):
            for c in range(CELLS):
                a = base + r * (CELLS + 1) + c
                b, d = a + 1, a + CELLS + 1
                faces += [[a, b, d + 1], [a, d + 1, d]]
                gids += [i, i]
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(gids, np.int32))


def _rays(n=20, seed=11):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.7, 0.7, (n, 2))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (n, 1))
    d[: n // 2, :2] = rng.uniform(-0.04, 0.04, (n // 2, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[-2] = (0.3, 0.4, 10.0)          # from behind
    d[-2] = (0.0, 0.0, -1.0)
    o[-1] = (5.0, 5.0, 0.0)           # misses
    return o, d.astype(np.float32)


ORI, DIR = _rays()


def _scenes(nq, tier=None, extras=False, verts=None):
    v, f, gid = _stacked_quads(nq)
    v = v if verts is None else verts
    jmesh = JMesh.create(v, f, geom_ids=gid)
    tmesh = TriangleMesh.create(v, f, geom_ids=gid, device=CPU)
    jkw, tkw = {}, {}
    if extras:
        # a sphere between quads 2 and 3 and a plane behind quad 5
        jkw = dict(spheres=JSpheres.create([[0.2, 0.1, 2.5]], [0.3], [nq]),
                   planes=JPlanes.create([[0.0, 0.0, 1.0]], [7.0], [nq]))
        tkw = dict(spheres=Spheres.create([[0.2, 0.1, 2.5]], [0.3], [nq],
                                          device=CPU),
                   planes=Planes.create([[0.0, 0.0, 1.0]], [7.0], [nq],
                                        device=CPU))
    js = JScene.create(mesh=jmesh, materials=JMaterials.concatenate(
        [JMaterials.matte()] * (nq + 1)), **jkw)
    ts = Scene.create(mesh=tmesh, materials=Materials.concatenate(
        [Materials.matte(device=CPU)] * (nq + 1)), device=CPU, **tkw)
    if tier is not None:
        js = dataclasses.replace(js, bvh=jbuild(jmesh, cluster_size=8,
                                                treelet_size=tier))
        ts.bvh = build_cluster_bvh(tmesh, cluster_size=8, treelet_size=tier)
        assert ts.bvh.num_clusters == js.bvh.num_clusters
    return js, ts


def _jray(o=ORI, d=DIR):
    return JRay(ori=jnp.asarray(o), dir=jnp.asarray(d))


def _tray(o=ORI, d=DIR):
    return Ray(ori=torch.from_numpy(o), dir=torch.from_numpy(d))


def _same(trec, jrec):
    hit = np.asarray(jrec.hit)
    np.testing.assert_array_equal(trec.hit.numpy(), hit)
    np.testing.assert_array_equal(trec.t.numpy()[~hit], FLT_MAX)
    np.testing.assert_allclose(trec.t.numpy()[hit], np.asarray(jrec.t)[hit],
                               rtol=1e-6)
    for f in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(getattr(trec, f).numpy()[hit],
                                      np.asarray(getattr(jrec, f))[hit])


@pytest.mark.parametrize("tier", [4, 0], ids=["heap", "radix"])
def test_cluster_matches_jax(tier):
    js, ts = _scenes(5, tier)
    k = 4
    trec = ttrace.multi_hit(_tray(), ts, k=k)
    _same(trec, jtrace.multi_hit(_jray(), js, k=k))
    assert trec.t.shape == (ORI.shape[0], k)
    hit = trec.hit.numpy()
    assert hit[:-1].all() and not hit[-1].any()
    t = trec.t.numpy()
    assert (np.diff(t[:-1], axis=-1) > 0).all()
    # against the port's own sweep
    brute = ttrace.multi_hit(_tray(), ts, k=k, use_bvh=False)
    np.testing.assert_array_equal(brute.hit.numpy(), hit)
    np.testing.assert_allclose(brute.t.numpy()[hit], t[hit], rtol=1e-6)


@pytest.mark.parametrize("k", [3, 16])
def test_brute_with_spheres_and_planes_matches_jax(k):
    js, ts = _scenes(5, extras=True)
    _same(ttrace.multi_hit(_tray(), ts, k=k),
          jtrace.multi_hit(_jray(), js, k=k))


def test_k_truncates_sorted():
    js, ts = _scenes(6, tier=0)
    straight = slice(ORI.shape[0] // 2, -2)
    rec = ttrace.multi_hit(_tray(), ts, k=3)
    np.testing.assert_allclose(rec.t.numpy()[straight],
                               np.broadcast_to([1.0, 2.0, 3.0], (8, 3)),
                               rtol=1e-5)
    np.testing.assert_array_equal(rec.geom_id.numpy()[straight],
                                  np.broadcast_to([0, 1, 2], (8, 3)))


def test_pads_past_the_candidates_and_breaks_ties_low():
    """Two coincident triangles (a tie at every hit) and k above the
    triangle count: slots past the candidates pad with hit=False,
    t=FLT_MAX; the tie goes to the lower prim id, as in JAX."""
    v = np.float32([[-1, -1, 2], [1, -1, 2], [0, 1, 2]] * 2)
    f = np.int32([[0, 1, 2], [3, 4, 5]])
    jmesh = JMesh.create(v, f)
    tmesh = TriangleMesh.create(v, f, device=CPU)
    js = JScene.create(mesh=jmesh, materials=JMaterials.matte())
    ts = Scene.create(mesh=tmesh, materials=Materials.matte(device=CPU),
                      device=CPU)
    o = np.float32([[0.0, -0.2, 0.0], [0.1, 0.1, 0.0]])
    d = np.float32([[0.0, 0.0, 1.0]] * 2)
    jrec = jtrace.multi_hit(_jray(o, d), js, k=5)
    trec = ttrace.multi_hit(_tray(o, d), ts, k=5)
    _same(trec, jrec)
    np.testing.assert_array_equal(trec.hit.numpy(),
                                  [[True, True, False, False, False]] * 2)
    np.testing.assert_array_equal(trec.prim_id.numpy()[:, :2], [[0, 1]] * 2)


def test_gradient_matches_jax():
    v0, f, gid = _stacked_quads(5)
    wgt = np.linspace(0.5, 1.5, 3, dtype=np.float32)

    def jloss(v):
        mesh = JMesh.create(v, f, geom_ids=gid)
        js = JScene.create(mesh=mesh, bvh=jbuild(mesh, cluster_size=8),
                           materials=JMaterials.matte())
        rec = jtrace.multi_hit(_jray(), js, k=3)
        return jnp.sum(jnp.where(rec.hit, rec.t * (1.0 + rec.v) * wgt, 0.0))

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(v0)))

    v = torch.tensor(v0, requires_grad=True)
    mesh = TriangleMesh.create(v, f, geom_ids=gid, device=CPU)
    ts = Scene.create(mesh=mesh, bvh=build_cluster_bvh(mesh, cluster_size=8),
                      materials=Materials.matte(device=CPU), device=CPU)
    rec = ttrace.multi_hit(_tray(), ts, k=3)
    loss = torch.sum(torch.where(rec.hit, rec.t * (1.0 + rec.v)
                                 * torch.from_numpy(wgt), 0.0))
    (g,) = torch.autograd.grad(loss, v)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0.1
    rel = np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
    assert rel <= 1e-5, rel
