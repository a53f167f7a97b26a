"""The port's LBVH tier (visionaray_torch/ops/traversal.py) against the JAX
package's jnp tier (visionaray_tpu/ops/traversal.py) on the CPU, on the
same tree: the JAX-built LBVH carried across by ``convert.bvh_from_arrays``
(the build itself is held by tests/test_torch_lbvh.py).  On CPU tensors
the wrapper runs its plain version.

Held: ``bvh_closest_hit``, ``bvh_any_hit`` (per-lane max_t, dead lanes)
and ``bvh_multi_hit`` (k = 1, 4, 16) -- hit equal everywhere, t to rtol
1e-6, prim equal where the nearest hit is unique (any-hit: the prim equal
everywhere, both walk the same order); the single-leaf tree; axis-aligned
rays whose origins lie on box planes (NaN slab entries, the box missed);
the refusal of a tree deeper than the stack; ``closest_hit`` and
``any_hit`` through a hit filter against JAX's in-traversal filter (the
port re-traces); the scene dispatch with spheres and planes merged in; the
vertex and ray gradients of sum(t) against ``jax.grad`` (relative L2
1e-5).

Conditioning: t from Moeller-Trumbore carries the rounding of its sums
(JAX's ``jnp.sum`` against the port's left-to-right dot) amplified by
1/|cos|, cos between the ray and the triangle's plane normal.  t is held
to rtol 1e-6 where |cos| >= 0.1 and to 1e-7 / |cos| below (one hit here
has cos 7e-4 and t off by 6e-5 relative).  dt/dv grows as 1/cos and its
rounding faster: unweighted, both packages' f32 vertex gradients are
1.4e-5 and 1.9e-5 (relative L2) off the f64 value, so the gradient test
weights each lane's t by min(1, 3 |cos|)^3 (then 5.7e-6 and 4.4e-6).
"""

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
from visionaray_tpu.ops import lbvh as jl
from visionaray_tpu.ops import trace as jtrace
from visionaray_tpu.ops import traversal as jt
from visionaray_tpu.scenes import random_triangles

from visionaray_torch.convert import bvh_from_arrays
from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import lbvh as tl
from visionaray_torch.ops import trace as ttrace
from visionaray_torch.ops import traversal as tt
from visionaray_torch.ops.intersect import intersect_triangle

torch.set_num_threads(1)
CPU = "cpu"
BVH_FIELDS = ("node_lo", "node_hi", "left", "right", "parent", "prim_ids",
              "leaf_first", "leaf_count")

VERTS, FACES = random_triangles(160, seed=21, extent=4.0, tri_size=1.2)
GIDS = (np.arange(FACES.shape[0]) % 3).astype(np.int32)


def bvh_dict(jb):
    d = {f: (None if getattr(jb, f) is None else np.asarray(getattr(jb, f)))
         for f in BVH_FIELDS}
    d["max_leaf_size"] = jb.max_leaf_size
    return d


def _rays(n=240, seed=5):
    """Rays from around the soup, half aimed at triangle centroids."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    cent = VERTS.reshape(-1, 3, 3).mean(axis=1)
    aim = cent[rng.integers(0, cent.shape[0], n // 2)]
    d[: n // 2] = aim - o[: n // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


ORI, DIR = _rays()


@pytest.fixture(scope="module")
def trees():
    jm = JMesh.create(VERTS, FACES, geom_ids=GIDS)
    tm = TriangleMesh.create(VERTS, FACES, geom_ids=GIDS, device=CPU)
    jb = jl.build_lbvh(jm)
    return jm, jb, tm, bvh_from_arrays(bvh_dict(jb), device=CPU)


def _jray(o=ORI, d=DIR):
    return JRay(jnp.asarray(o), jnp.asarray(d))


def _tray(o=ORI, d=DIR):
    return Ray(torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)))


def _unique(o, d, t_best, hit):
    """Lanes whose nearest hit is unique: one triangle within 1e-6 of the
    best t (a brute sweep)."""
    v1 = VERTS[FACES[:, 0]]
    e1 = VERTS[FACES[:, 1]] - v1
    e2 = VERTS[FACES[:, 2]] - v1
    t, _, _, h = intersect_triangle(
        torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None],
        torch.from_numpy(v1), torch.from_numpy(e1), torch.from_numpy(e2))
    t, h = t.numpy(), h.numpy()
    near = h & (t >= 0) & (np.abs(t - t_best[:, None])
                           <= 1e-6 * np.abs(t_best[:, None]))
    return hit & (near.sum(axis=1) == 1)


def _cos(prim_id, d, normals):
    """|cos| between each ray and the plane normal of its hit triangle."""
    n = normals[np.clip(np.asarray(prim_id), 0, normals.shape[0] - 1)]
    return np.abs((n * d).sum(axis=-1))


def _same_t(got, ref, hit, cos):
    """t to rtol 1e-6, or 1e-7 / |cos| on ill-conditioned hits."""
    rtol = 1e-6 * np.maximum(1.0, 0.1 / np.maximum(cos, 1e-12))
    assert (np.abs(got - ref)[hit] <= rtol[hit] * np.abs(ref)[hit]).all()
    assert (cos[hit] >= 0.1).sum() >= 0.8 * hit.sum()


def _same_closest(thr, jhr, normals, o=ORI, d=DIR):
    hit = np.asarray(jhr.hit)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    jt_ = np.asarray(jhr.t)
    cos = _cos(jhr.prim_id, d, normals)
    _same_t(thr.t.numpy(), jt_, hit, cos)
    assert (thr.t.numpy()[~hit] == np.float32(3.4028235e38)).all()
    uniq = _unique(o, d, jt_, hit)
    assert uniq.sum() >= 0.9 * hit.sum()
    for f in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(getattr(thr, f).numpy()[uniq],
                                      np.asarray(getattr(jhr, f))[uniq])
    well = uniq & (cos >= 0.1)
    np.testing.assert_allclose(thr.u.numpy()[well], np.asarray(jhr.u)[well],
                               atol=1e-5)
    return hit


def test_closest_hit_matches_jax(trees):
    jm, jb, tm, tb = trees
    hit = _same_closest(tt.bvh_closest_hit(_tray(), tb, tm),
                        jt.bvh_closest_hit(_jray(), jb, jm),
                        tm.normals.numpy())
    assert 100 < hit.sum() < hit.size


def test_any_hit_matches_jax(trees):
    jm, jb, tm, tb = trees
    max_t = np.random.default_rng(9).uniform(0.5, 9.0, ORI.shape[0]).astype(
        np.float32)
    max_t[::11] = -1.0          # dead lanes
    max_t[5::11] = 0.0
    jhr = jt.bvh_any_hit(_jray(), jb, jm, jnp.asarray(max_t))
    thr = tt.bvh_any_hit(_tray(), tb, tm, torch.from_numpy(max_t))
    hit = np.asarray(jhr.hit)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    np.testing.assert_array_equal(thr.prim_id.numpy(), np.asarray(jhr.prim_id))
    _same_t(thr.t.numpy(), np.asarray(jhr.t), hit,
            _cos(jhr.prim_id, DIR, tm.normals.numpy()))
    assert not hit[::11].any() and not hit[5::11].any()
    assert 40 < hit.sum() < hit.size


@pytest.mark.parametrize("k", [1, 4, 16])
def test_multi_hit_matches_jax(trees, k):
    jm, jb, tm, tb = trees
    jhr = jt.bvh_multi_hit(_jray(), jb, jm, k)
    thr = tt.bvh_multi_hit(_tray(), tb, tm, k)
    hit = np.asarray(jhr.hit)
    assert thr.t.shape == (ORI.shape[0], k)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    _same_t(thr.t.numpy(), np.asarray(jhr.t), hit,
            _cos(jhr.prim_id, DIR[:, None], tm.normals.numpy()))
    np.testing.assert_array_equal(thr.prim_id.numpy()[hit],
                                  np.asarray(jhr.prim_id)[hit])
    t = thr.t.numpy()
    assert (t[:, 1:] >= t[:, :-1]).all()
    if k > 1:
        assert hit[:, 1].sum() > 20


def test_single_leaf_tree_matches_jax():
    v, f = VERTS[:3], FACES[:1]
    jm = JMesh.create(v, f)
    tm = TriangleMesh.create(v, f, device=CPU)
    jb = jl.build_lbvh(jm)
    tb = bvh_from_arrays(bvh_dict(jb), device=CPU)
    assert tb.num_nodes == 1
    cent = v.mean(axis=0)
    d = (cent - ORI).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _same_closest(tt.bvh_closest_hit(_tray(d=d), tb, tm),
                  jt.bvh_closest_hit(_jray(d=d), jb, jm),
                  tm.normals.numpy(), d=d)
    mt = np.full(ORI.shape[0], 100.0, np.float32)
    ja = jt.bvh_any_hit(_jray(d=d), jb, jm, jnp.asarray(mt))
    ta = tt.bvh_any_hit(_tray(d=d), tb, tm, torch.from_numpy(mt))
    np.testing.assert_array_equal(ta.hit.numpy(), np.asarray(ja.hit))
    assert ta.hit.numpy().sum() > 100
    # JAX's bvh_multi_hit cannot index the empty child arrays of a
    # single-leaf tree; the port's walk starts at the leaf: slot 0 is the
    # closest hit, slot 1 empty
    tmh = tt.bvh_multi_hit(_tray(d=d), tb, tm, 2)
    tch = tt.bvh_closest_hit(_tray(d=d), tb, tm)
    np.testing.assert_array_equal(tmh.hit.numpy()[:, 0], tch.hit.numpy())
    np.testing.assert_array_equal(tmh.t.numpy()[:, 0], tch.t.numpy())
    assert not tmh.hit.numpy()[:, 1].any()


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_nan_slab_rays_match_jax(trees, mode):
    """Axis-aligned rays whose origins lie on the planes of node boxes:
    0 * inf is NaN in the slab test, and the box is missed (JAX does not
    clamp 1/d and its min/max propagate NaN)."""
    jm, jb, tm, tb = trees
    lo = np.asarray(jb.node_lo)[:60]
    hi = np.asarray(jb.node_hi)[:60]
    o = np.concatenate([lo, hi, lo]).astype(np.float32)
    d = np.zeros_like(o)
    d[:60, 0] = 1.0
    d[60:120, 1] = -1.0
    d[120:, 2] = 1.0
    # the NaN case does occur: a zero component on a box plane
    with np.errstate(divide="ignore", invalid="ignore"):
        assert np.isnan((lo - lo) * (1.0 / d[:60])).any()
    if mode == "closest":
        _same_closest(tt.bvh_closest_hit(_tray(o, d), tb, tm),
                      jt.bvh_closest_hit(_jray(o, d), jb, jm),
                      tm.normals.numpy(), o, d)
    else:
        mt = np.full(o.shape[0], 50.0, np.float32)
        jhr = jt.bvh_any_hit(_jray(o, d), jb, jm, jnp.asarray(mt))
        thr = tt.bvh_any_hit(_tray(o, d), tb, tm, torch.from_numpy(mt))
        np.testing.assert_array_equal(thr.hit.numpy(), np.asarray(jhr.hit))
        np.testing.assert_array_equal(thr.prim_id.numpy(),
                                      np.asarray(jhr.prim_id))


def _chain(depth):
    """A caterpillar tree of ``depth`` levels: internal node i has leaf i
    on its left and node i + 1 on its right."""
    L = depth + 1
    left = np.arange(L - 1, dtype=np.int32) + (L - 1)
    right = np.arange(1, L, dtype=np.int32)
    right[-1] = 2 * L - 2
    box_lo = np.full((2 * L - 1, 3), -1.0, np.float32)
    box_hi = np.full((2 * L - 1, 3), 1.0, np.float32)
    parent = np.full((2 * L - 1,), -1, np.int32)
    parent[left] = np.arange(L - 1)
    parent[right] = np.arange(L - 1)
    return tl.BVH(node_lo=torch.tensor(box_lo), node_hi=torch.tensor(box_hi),
                  left=torch.tensor(left), right=torch.tensor(right),
                  parent=torch.tensor(parent),
                  prim_ids=torch.arange(L, dtype=torch.int32))


def test_stack_refusal():
    """JAX clips its stack index and would lose nodes silently; the port
    refuses a tree deeper than its 64 entries, in the wrapper and in the
    plain version."""
    verts = np.tile(VERTS[:3], (66, 1))
    faces = np.arange(66 * 3, dtype=np.int32).reshape(66, 3)
    mesh = TriangleMesh.create(verts, faces, device=CPU)
    tabs = tt.prim_tables("triangle", mesh)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    mt = torch.full((4,), 10.0)
    ok = _chain(64)
    assert ok.depth == 64
    tt.bvh_traverse(o, d, mt, ok, "triangle", tabs, "closest")
    deep = _chain(65)
    assert deep.depth == 65
    for fn in (tt.bvh_traverse, tt.traverse_bvh_plain):
        with pytest.raises(ValueError, match="stack"):
            fn(o, d, mt, deep, "triangle", tabs, "closest")
    scene = Scene.create(mesh=mesh, bvh=deep, device=CPU)
    with pytest.raises(ValueError, match="stack"):
        ttrace.closest_hit(Ray(o, d), scene)


def _reject_mod3(pid, t, u, v, hit):
    return hit & (pid % 3 != 0)


def _scenes(trees, extras=False):
    jm, jb, tm, tb = trees
    kw_j, kw_t = {}, {}
    if extras:
        c = np.float32([[0.0, 0.0, 0.0], [2.0, -1.0, 1.0]])
        r = np.float32([1.0, 0.7])
        kw_j = dict(spheres=JSpheres.create(c, r, geom_ids=[1, 2]),
                    planes=JPlanes.create([[0.0, 1.0, 0.0]], [-3.0]))
        kw_t = dict(spheres=Spheres.create(c, r, geom_ids=[1, 2],
                                           device=CPU),
                    planes=Planes.create([[0.0, 1.0, 0.0]], [-3.0],
                                         device=CPU))
    return (JScene.create(mesh=jm, bvh=jb, **kw_j),
            Scene.create(mesh=tm, bvh=tb, device=CPU, **kw_t))


def test_filtered_closest_hit_matches_jax(trees):
    """JAX filters inside the walk; the port re-traces past each rejected
    winner.  Both answer the closest surviving hit."""
    js, ts = _scenes(trees)
    jhr = jtrace.closest_hit(_jray(), js, hit_filter=_reject_mod3)
    thr = ttrace.closest_hit(_tray(), ts, hit_filter=_reject_mod3)
    hit = _same_closest(thr, jhr, trees[2].normals.numpy())
    assert hit.sum() > 80
    assert not (thr.prim_id.numpy()[hit] % 3 == 0).any()
    # any-hit through the filter: the same occlusion answer
    mt = np.full(ORI.shape[0], 6.0, np.float32)
    ja = jtrace.any_hit(_jray(), js, jnp.asarray(mt), hit_filter=_reject_mod3)
    ta = ttrace.any_hit(_tray(), ts, torch.from_numpy(mt),
                        hit_filter=_reject_mod3)
    np.testing.assert_array_equal(ta.hit.numpy(), np.asarray(ja.hit))


@pytest.mark.parametrize("query", ["closest", "any", "multi"])
def test_scene_dispatch_matches_jax(trees, query):
    """closest_hit / any_hit / multi_hit on a Scene with an LBVH, spheres
    and a plane merged in (per-lane max_t on closest and any)."""
    js, ts = _scenes(trees, extras=True)
    mt = np.random.default_rng(3).uniform(-1.0, 12.0,
                                          ORI.shape[0]).astype(np.float32)
    if query == "closest":
        jhr = jtrace.closest_hit(_jray(), js, max_t=jnp.asarray(mt))
        thr = ttrace.closest_hit(_tray(), ts, max_t=torch.from_numpy(mt))
    elif query == "any":
        jhr = jtrace.any_hit(_jray(), js, jnp.asarray(mt))
        thr = ttrace.any_hit(_tray(), ts, torch.from_numpy(mt))
    else:
        jhr = jtrace.multi_hit(_jray(), js, k=6)
        thr = ttrace.multi_hit(_tray(), ts, k=6)
    hit = np.asarray(jhr.hit)
    pid = np.asarray(jhr.prim_id)
    d = DIR if pid.ndim == 1 else DIR[:, None]
    cos = np.where(pid < FACES.shape[0],
                   _cos(pid, d, ts.mesh.normals.numpy()), 1.0)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    _same_t(thr.t.numpy(), np.asarray(jhr.t), hit, cos)
    np.testing.assert_array_equal(thr.prim_id.numpy()[hit], pid[hit])
    assert hit.sum() > 50


def test_gradients_match_jax(trees):
    """d sum(w t) / d (vertices, ray origin, ray direction) through the
    search's recompute at the winning primitive; w = min(1, 3 |cos|)^3
    (module docstring)."""
    jm, jb, tm, tb = trees
    ref = jt.bvh_closest_hit(_jray(), jb, jm)
    w = np.minimum(1.0, 3.0 * _cos(ref.prim_id, DIR, tm.normals.numpy()))
    w = (w ** 3).astype(np.float32)

    def jloss(v, o, d):
        mesh = JMesh.create(v, FACES, geom_ids=GIDS)
        hr = jt.bvh_closest_hit(JRay(o, d), jb, mesh)
        return jnp.sum(jnp.where(hr.hit, w * hr.t, 0.0))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(VERTS),
                                           jnp.asarray(ORI), jnp.asarray(DIR))
    v = torch.from_numpy(VERTS.copy()).requires_grad_()
    o = torch.from_numpy(ORI.copy()).requires_grad_()
    d = torch.from_numpy(DIR.copy()).requires_grad_()
    mesh = TriangleMesh(**{**vars(tm), "vertices": v})
    hr = tt.bvh_closest_hit(Ray(o, d), tb, mesh)
    torch.where(hr.hit, torch.from_numpy(w) * hr.t, 0.0).sum().backward()
    for got, ref in zip((v.grad, o.grad, d.grad), jg):
        ref = np.asarray(ref, np.float64)
        got = got.numpy().astype(np.float64)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)
