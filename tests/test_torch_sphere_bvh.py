"""The port's sphere BVH (``build_sphere_bvh``, ``sphere_bvh_closest_hit``,
``sphere_bvh_any_hit``) against the JAX package on the CPU, on the pattern
of tests/test_sphere_bvh.py: the build equal to JAX's and structurally
valid; closest and any hits against JAX's on the same tree (hit and prim
equal, t to rtol 1e-6) and against the port's brute-force sweep; radii
from 1e-9 to 1e5 (the reference's degenerate build set); ``closest_hit``
and ``any_hit`` dispatching through ``Scene.sphere_bvh`` with triangles
and a plane merged in; and the centre, radius and ray gradients of sum(t)
against ``jax.grad`` (relative L2 1e-5).

Two properties of the tier, the reference's as much as the port's:
- A sphere of radius 1e-9 at |centre| ~ 10 has a box of zero extent
  (c -/+ r round to c).  A ray aimed at its centre can hit it in the
  quadratic yet miss the point box, so the walk (JAX's and the port's
  alike) may miss what the brute sweep hits: the sweep comparison leaves
  out lanes whose swept hit is such a sphere (radius below 1e-6 |c|).
- Any-hit returns the t of the walk's own test.  In JAX that test runs
  inside the vmapped while loop, where XLA rounds the quadratic
  differently from the same jnp code outside it (up to 5e-5 relative
  here, where the quadratic itself is 3.8e-4 off the f64 value); such t
  are held to JAX's at rtol 1e-4 (tests/test_sphere_bvh.py's tolerance for
  the same reason) and bit-equal to the port's own intersect_sphere at the
  same prim.
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
from visionaray_tpu.ops import trace as jtrace
from visionaray_tpu.ops import traversal as jt

from visionaray_torch.convert import scene_from_arrays
from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import lbvh as tl
from visionaray_torch.ops import trace as ttrace
from visionaray_torch.ops import traversal as tt

from test_torch_bvh_traversal import bvh_dict

torch.set_num_threads(1)
CPU = "cpu"
N = 600


def _spheres(seed=11, n=N):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    radius = np.exp(rng.uniform(np.log(0.05), np.log(0.8), n)).astype(
        np.float32)
    radius[::60] = 1e-9
    gids = rng.integers(0, 3, n).astype(np.int32)
    return center, radius, gids


def _rays(center, n=256, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)
    d = (center[rng.integers(0, center.shape[0], n)] - o).astype(np.float32)
    d[200:] = rng.normal(size=(n - 200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


C, R, G = _spheres()
ORI, DIR = _rays(C)


@pytest.fixture(scope="module")
def groups():
    js = JSpheres.create(C, R, G)
    ts = Spheres.create(C, R, G, device=CPU)
    return js, jt.build_sphere_bvh(js), ts, tt.build_sphere_bvh(ts)


def _jray(o=ORI, d=DIR):
    return JRay(jnp.asarray(o), jnp.asarray(d))


def _tray(o=ORI, d=DIR):
    return Ray(torch.from_numpy(o.copy()), torch.from_numpy(d.copy()))


def _same(thr, jhr, rtol=1e-6):
    hit = np.asarray(jhr.hit)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    np.testing.assert_allclose(thr.t.numpy()[hit], np.asarray(jhr.t)[hit],
                               rtol=rtol)
    for f in ("prim_id", "geom_id"):
        np.testing.assert_array_equal(getattr(thr, f).numpy()[hit],
                                      np.asarray(getattr(jhr, f))[hit])
    return hit


def _point_box(ref, offset=0):
    """Lanes whose swept hit is a sphere with a zero-extent box (module
    docstring); at most 2 here."""
    pid = ref.prim_id.numpy() - offset
    mask = ref.hit.numpy() & (R[pid] < 1e-6 * np.abs(C[pid]).max(axis=-1))
    assert mask.sum() <= 2
    return mask


def _walk_t_is_own_test(thr, ts, hit, o=ORI, d=DIR):
    """The any-hit t is the port's intersect_sphere at the same prim."""
    from visionaray_torch.ops.intersect import intersect_sphere
    p = torch.from_numpy(thr.prim_id.numpy()[hit])
    t, _ = intersect_sphere(torch.from_numpy(o[hit]), torch.from_numpy(d[hit]),
                            ts.center[p], ts.radius[p])
    np.testing.assert_array_equal(thr.t.numpy()[hit], t.numpy())


def test_build_equals_jax_and_is_valid(groups):
    js, jb, ts, tb = groups
    for f in ("node_lo", "node_hi", "left", "right", "parent", "prim_ids"):
        assert np.array_equal(np.asarray(getattr(jb, f)),
                              getattr(tb, f).numpy()), f
    r = R[:, None]
    checks = tl.validate(tb, C - r, C + r)
    assert all(checks.values()), checks


def test_closest_matches_jax_and_sweep(groups):
    js, jb, ts, tb = groups
    thr = tt.sphere_bvh_closest_hit(_tray(), tb, ts, prim_offset=7)
    hit = _same(thr, jt.sphere_bvh_closest_hit(_jray(), jb, js,
                                               prim_offset=7))
    assert hit.sum() >= 150
    ref = ttrace.intersect_spheres_brute(_tray(), ts.center, ts.radius,
                                         ts.geom_ids, 7)
    point_box = _point_box(ref, 7)
    hit = hit & ~point_box
    np.testing.assert_array_equal(ref.hit.numpy() & ~point_box, hit)
    np.testing.assert_array_equal(ref.prim_id.numpy()[hit],
                                  thr.prim_id.numpy()[hit])
    np.testing.assert_array_equal(ref.t.numpy()[hit], thr.t.numpy()[hit])


def test_any_matches_jax_and_sweep(groups):
    js, jb, ts, tb = groups
    ref = ttrace.intersect_spheres_brute(_tray(), ts.center, ts.radius,
                                         ts.geom_ids)
    mt = np.where(ref.hit.numpy(), ref.t.numpy() * 0.9, 1e30).astype(
        np.float32)
    mt[::5] = 1e30
    jhr = jt.sphere_bvh_any_hit(_jray(), jb, js, jnp.asarray(mt))
    thr = tt.sphere_bvh_any_hit(_tray(), tb, ts, torch.from_numpy(mt))
    hit = _same(thr, jhr, rtol=1e-4)
    _walk_t_is_own_test(thr, ts, hit)
    # in front of the closest hit: free; with max_t 1e30: occluded
    free = ref.hit.numpy() & (mt < 1e30)
    assert not hit[free].any()
    far = (mt == 1e30) & ~_point_box(ref)
    np.testing.assert_array_equal(hit[far], ref.hit.numpy()[far])


def test_degenerate_radii():
    """Radii from 1e-9 to 1e5 (reference build.cpp:69-116): the tree stays
    valid and rays aimed at the centres hit what the sweep hits."""
    n = 64
    radius = np.logspace(-9, 5, n).astype(np.float32)
    center = np.random.default_rng(5).uniform(-4.0, 4.0, (n, 3)).astype(
        np.float32)
    js = JSpheres.create(center, radius)
    ts = Spheres.create(center, radius, device=CPU)
    jb, tb = jt.build_sphere_bvh(js), tt.build_sphere_bvh(ts)
    r = radius[:, None]
    assert all(tl.validate(tb, center - r, center + r).values())
    o = np.full((n, 3), np.float32([0.0, 0.0, 3.0e5]))
    d = (center - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    thr = tt.sphere_bvh_closest_hit(_tray(o, d), tb, ts)
    _same(thr, jt.sphere_bvh_closest_hit(_jray(o, d), jb, js))
    ref = ttrace.intersect_spheres_brute(_tray(o, d), ts.center, ts.radius,
                                         ts.geom_ids)
    np.testing.assert_array_equal(thr.hit.numpy(), ref.hit.numpy())
    assert thr.hit.numpy().all()


@pytest.mark.parametrize("query", ["closest", "any"])
def test_scene_dispatch_through_sphere_bvh(groups, query):
    """``Scene.sphere_bvh``: closest_hit / any_hit take the sphere BVH,
    with a triangle and a plane merged in, against JAX's scene query; the
    scene carried across by ``convert.scene_from_arrays``."""
    js, jb, ts, tb = groups
    verts = np.float32([[-3, -3, 0], [3, -3, 0], [0, 3, 0]])
    faces = np.int32([[0, 1, 2]])
    jscene = JScene.create(mesh=JMesh.create(verts, faces), spheres=js,
                           planes=JPlanes.create([[0, 1, 0]], [-11.0]),
                           sphere_bvh=jb)
    tscene = scene_from_arrays(
        mesh=dict(vertices=verts, faces=faces,
                  **{k: np.asarray(getattr(jscene.mesh, k))
                     for k in ("geom_ids", "normals", "corner_normals",
                               "tex_coords")},
                  face_normals_binding=True),
        spheres=dict(center=C, radius=R, geom_ids=G),
        planes=dict(normal=np.float32([[0, 1, 0]]),
                    offset=np.float32([-11.0]), geom_ids=np.int32([0])),
        sphere_bvh=bvh_dict(jb), device=CPU)
    assert isinstance(tscene.sphere_bvh, tl.BVH)
    mt = np.random.default_rng(8).uniform(-1.0, 25.0, ORI.shape[0]).astype(
        np.float32)
    if query == "closest":
        jhr = jtrace.closest_hit(_jray(), jscene, max_t=jnp.asarray(mt))
        thr = ttrace.closest_hit(_tray(), tscene, max_t=torch.from_numpy(mt))
    else:
        jhr = jtrace.any_hit(_jray(), jscene, jnp.asarray(mt))
        thr = ttrace.any_hit(_tray(), tscene, torch.from_numpy(mt))
    hit = _same(thr, jhr, rtol=1e-4 if query == "any" else 1e-6)
    pid = thr.prim_id.numpy()[hit]
    assert (pid >= 1).sum() > 50 and (pid == 0).any()


def test_gradients_match_jax(groups):
    js, jb, ts, tb = groups

    def jloss(c, r, o, d):
        sp = JSpheres.create(c, r, G)
        hr = jt.sphere_bvh_closest_hit(JRay(o, d), jb, sp)
        return jnp.sum(jnp.where(hr.hit, hr.t, 0.0))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(C), jnp.asarray(R), jnp.asarray(ORI), jnp.asarray(DIR))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (C, R, ORI, DIR)]
    sp = Spheres(center=leaves[0], radius=leaves[1],
                 geom_ids=torch.from_numpy(G))
    hr = tt.sphere_bvh_closest_hit(Ray(leaves[2], leaves[3]), tb, sp)
    torch.where(hr.hit, hr.t, 0.0).sum().backward()
    for got, ref in zip(leaves, jg):
        ref = np.asarray(ref, np.float64)
        got = got.grad.numpy().astype(np.float64)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)
