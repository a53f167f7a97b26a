"""The port's hit filters (the custom-intersector hook ``fn(prim_id, t, u,
v, hit) -> hit``) against the JAX package on the CPU, on the pattern of
tests/test_hit_filter.py.

A rejected hit must fall through to the next surface along the ray.  The
scene is three stacked quads at z = 1, 2, 3, each a 4x4 grid of cells (32
triangles, so a K=8 ClusterBVH has 12 clusters), with rays at seeded
random points through them, one ray pointing away and one missing.  The
tiers: the brute-force sweep, and the ClusterBVH as a kd heap
(treelet_size=4) and as a radix tree (treelet_size=0), each package
building its own tree; on the CPU the port's traversal wrapper runs its
plain version, JAX its Pallas kernel in interpret mode.  The filters:
rejecting the first quad (on every tier), the first two and all (brute
force and radix), and a checkerboard flipped quad to quad (both cluster
tiers); any-hit through a filter on brute force and radix.  Held: ``hit`` and ``prim_id`` equal, t to rtol 1e-6 (and
to the quad's z to 1e-5), ``geom_id`` equal.  Gradients through the
filtered cluster trace against ``jax.grad``: relative L2 <= 1e-5.  A
simple frame with a filter on sponza_like(2000)'s radix tree: test
_torch_simple.py's image tolerance (mean abs <= 1e-4, at most 2% of
pixels off by more than 1e-3) and depths to rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.ops import trace as jtrace
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading.materials import Materials as JMaterials

from visionaray_torch.core.scene import Scene, TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import trace as ttrace
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender
from visionaray_torch.shading.materials import Materials

torch.set_num_threads(1)
CPU = "cpu"
NQ, CELLS = 3, 4
PER_QUAD = 2 * CELLS * CELLS


def _stacked_quads(n=NQ):
    verts, faces, gids = [], [], []
    g = np.linspace(-1.0, 1.0, CELLS + 1)
    for i in range(n):
        z = 1.0 + i
        base = len(verts)
        verts += [[x, y, z] for y in g for x in g]
        for r in range(CELLS):
            for c in range(CELLS):
                a = base + r * (CELLS + 1) + c
                b, d = a + 1, a + CELLS + 1
                faces += [[a, b, d + 1], [a, d + 1, d]]
                gids += [i, i]
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(gids, np.int32))


VERTS, FACES, GIDS = _stacked_quads()


def _rays(n=24, seed=7):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.8, 0.8, (n, 2))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (n, 1))
    d[: n // 2, :2] = rng.uniform(-0.05, 0.05, (n // 2, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[-2] = (0.0, 0.0, -1.0)          # points away: no hit
    o[-1] = (5.0, 5.0, 0.0)           # misses the quads
    return o, d.astype(np.float32)


ORI, DIR = _rays()


def _reject_first_quad(pid, t, u, v, hit):
    # "alpha = 0" on the nearest quad: see through it
    return hit & (pid >= PER_QUAD)


def _reject_two(pid, t, u, v, hit):
    return hit & (pid >= 2 * PER_QUAD)


def _reject_all(pid, t, u, v, hit):
    return hit & (pid < 0)


def _checker(pid, t, u, v, hit):
    # checkerboard transparency, flipped quad to quad: each ray falls
    # through a varying number of quads
    return hit & ((pid // 2 + pid // PER_QUAD) % 2 == 0)


FILTERS = {"first_quad": _reject_first_quad, "two": _reject_two,
           "all": _reject_all, "checker": _checker}
TIERS = {"brute": None, "heap": 4, "radix": 0}


def _scenes(tier, verts=VERTS):
    jmesh = JMesh.create(verts, FACES, geom_ids=GIDS)
    js = JScene.create(mesh=jmesh,
                       materials=JMaterials.concatenate(
                           [JMaterials.matte()] * NQ))
    tmesh = TriangleMesh.create(verts, FACES, geom_ids=GIDS, device=CPU)
    ts = Scene.create(mesh=tmesh,
                      materials=Materials.concatenate(
                          [Materials.matte(device=CPU)] * NQ), device=CPU)
    T = TIERS[tier]
    if T is not None:
        js = dataclasses.replace(js, bvh=jbuild(jmesh, cluster_size=8,
                                                treelet_size=T))
        ts.bvh = build_cluster_bvh(tmesh, cluster_size=8, treelet_size=T)
        assert ts.bvh.heap == (T > 0)
        assert ts.bvh.num_clusters == js.bvh.num_clusters >= 12
    return js, ts


def _jray():
    return JRay(ori=jnp.asarray(ORI), dir=jnp.asarray(DIR))


def _tray():
    return Ray(ori=torch.from_numpy(ORI), dir=torch.from_numpy(DIR))


def _same(thr, jhr):
    hit = np.asarray(jhr.hit)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    np.testing.assert_allclose(thr.t.numpy()[hit], np.asarray(jhr.t)[hit],
                               rtol=1e-6)
    np.testing.assert_array_equal(thr.prim_id.numpy()[hit],
                                  np.asarray(jhr.prim_id)[hit])
    np.testing.assert_array_equal(thr.geom_id.numpy()[hit],
                                  np.asarray(jhr.geom_id)[hit])


@pytest.mark.parametrize("name,tier", [
    ("first_quad", "brute"), ("first_quad", "heap"), ("first_quad", "radix"),
    ("two", "brute"), ("two", "radix"), ("all", "brute"), ("all", "radix"),
    ("checker", "heap"), ("checker", "radix")])
def test_closest_hit_filter_matches_jax(name, tier):
    js, ts = _scenes(tier)
    flt = FILTERS[name]
    jhr = jtrace.closest_hit(_jray(), js, hit_filter=flt)
    thr = ttrace.closest_hit(_tray(), ts, hit_filter=flt)
    _same(thr, jhr)
    hit = thr.hit.numpy()
    assert not hit[-2:].any()
    if name == "all":
        assert not hit.any()
    elif name in ("first_quad", "two"):
        # the surviving hit is the next quad back, not a miss
        quad = 1 if name == "first_quad" else 2
        assert hit[:-2].all()
        np.testing.assert_array_equal(thr.geom_id.numpy()[:-2], quad)
        straight = slice(DIR.shape[0] // 2, -2)
        np.testing.assert_allclose(thr.t.numpy()[straight], 1.0 + quad,
                                   rtol=1e-5)


@pytest.mark.parametrize("tier", ["brute", "radix"])
def test_any_hit_through_filter_matches_jax(tier):
    """Occlusion through a filter: the closest surviving hit under max_t
    (shadow rays see through rejected hits)."""
    js, ts = _scenes(tier)
    max_t = np.full(ORI.shape[0], 2.5, np.float32)
    max_t[:4] = 1.5            # only the first quad, which is rejected
    max_t[4] = -1.0            # a dead lane
    jhr = jtrace.any_hit(_jray(), js, jnp.asarray(max_t),
                         hit_filter=_reject_first_quad)
    thr = ttrace.any_hit(_tray(), ts, torch.from_numpy(max_t),
                         hit_filter=_reject_first_quad)
    np.testing.assert_array_equal(thr.hit.numpy(), np.asarray(jhr.hit))
    hit = thr.hit.numpy()
    assert not hit[:5].any() and hit[5:-2].all()
    np.testing.assert_allclose(thr.t.numpy()[hit], np.asarray(jhr.t)[hit],
                               rtol=1e-6)


def test_gradients_flow_through_filtered_trace():
    wgt = np.linspace(0.5, 1.5, ORI.shape[0], dtype=np.float32)

    def jloss(v):
        mesh = JMesh.create(v, FACES, geom_ids=GIDS)
        js = JScene.create(mesh=mesh, bvh=jbuild(mesh, cluster_size=8),
                           materials=JMaterials.concatenate(
                               [JMaterials.matte()] * NQ))
        hr = jtrace.closest_hit(_jray(), js, hit_filter=_checker)
        return jnp.sum(jnp.where(hr.hit, hr.t * (1.0 + hr.u) * wgt, 0.0))

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(VERTS)))

    v = torch.tensor(VERTS, requires_grad=True)
    mesh = TriangleMesh.create(v, FACES, geom_ids=GIDS, device=CPU)
    ts = Scene.create(mesh=mesh, bvh=build_cluster_bvh(mesh, cluster_size=8),
                      materials=Materials.concatenate(
                          [Materials.matte(device=CPU)] * NQ), device=CPU)
    hr = ttrace.closest_hit(_tray(), ts, hit_filter=_checker)
    loss = torch.sum(torch.where(hr.hit, hr.t * (1.0 + hr.u)
                                 * torch.from_numpy(wgt), 0.0))
    (g,) = torch.autograd.grad(loss, v)
    g = g.numpy()
    assert np.isfinite(g).all()
    # moving the second and third quads along z moves the surviving t
    assert np.abs(g[(CELLS + 1) ** 2:, 2]).sum() > 0.1
    rel = np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
    assert rel <= 1e-5, rel


def test_filtered_render_on_radix_tree_matches_jax():
    """render(..., hit_filter=f), the simple kernel on a radix tree: the
    filter rejects every prim whose id is 0 mod 7."""
    def flt(pid, t, u, v, hit):
        return hit & (pid % 7 != 0)

    W, H = 24, 16
    js, jcam = j_sponza(target_tris=2000, build_bvh=False)
    js = dataclasses.replace(js, bvh=jbuild(js.mesh, cluster_size=8,
                                            treelet_size=0))
    ts, tcam = sponza_like_scene(target_tris=2000, device=CPU)
    ts.bvh = build_cluster_bvh(ts.mesh, cluster_size=8, treelet_size=0)
    jrt = jrender.render(js, jcam, W, H, hit_filter=flt)
    trt = trender.render(ts, tcam, W, H, hit_filter=flt)
    got, ref = trt.color.numpy(), np.asarray(jrt.color)
    diff = np.abs(got - ref)
    assert np.isfinite(got).all() and diff.mean() <= 1e-4
    assert (diff.max(-1) > 1e-3).mean() <= 0.02
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5)
    plain = trender.render(ts, tcam, W, H)
    assert not np.array_equal(plain.depth.numpy(), trt.depth.numpy())
