"""Geometry sharding (parallel/ring.py) against the JAX package's, at 2
ranks here and at 4 in test_torch_geometry_sharding4.py
(tests/test_geometry_sharding.py's set-up).

64 random triangles (5 materials), 128 rays aimed at their centroids,
the JAX ``ShardedGeometry`` of each backend (brute force, a per-shard
LBVH, a per-shard radix ClusterBVH at K=8) carried across with
``convert.sharded_geometry_from_arrays``; JAX runs on ``make_mesh(D)``
(the cluster backend's kernel in interpret mode), the port on D gloo
ranks (tests/test_torch_multihost.py's harness).  Checked:

- the port's own ``shard_geometry`` equals JAX's: the morton order with
  the repeated tail face, the shard boxes, each shard's tree tables;
- closest hits: hit equal, t within rtol 1e-5, geometry ids equal, the
  global prim ids mapped back through ``prim_ids`` equal to JAX's
  (each maps to the face JAX's does: a tie between a face and its
  repeated copy may name either slot);
- any hits: equal flags at max_t = 1e30; none below 0.9 of the closest t;
- the gradients of sum(t over hits) with respect to the soup corners,
  each rank's shard summed and scattered to the faces: against the
  port's own unsharded brute-force gradient at JAX's own test's rule
  (rtol 1e-4, atol 1e-6 in at least 97% of the entries: closest-hit
  ties between coincident triangles may move a gradient), and against
  JAX's through ``shard_map`` within relative L2 5e-4: the two
  frameworks' Moeller-Trumbore gradients differ as much unsharded (the
  port's brute sweep against JAX's on this set-up: 1.5e-6, 9.6e-5 and
  2.2e-4 for v1, e1, e2; the sharded ones measure the same 2.1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.parallel import ring as jring
from visionaray_tpu.parallel.tile_sharding import make_mesh as jmake_mesh
from visionaray_tpu.scenes import random_triangles

from test_torch_multihost import run_ranks
from visionaray_torch import convert
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops.trace import intersect_triangles_brute
from visionaray_torch.parallel import ring as tring
from visionaray_torch.parallel.sharded_pt import soup_grads_to_faces

torch.set_num_threads(1)
CPU = "cpu"
BACKENDS = ("brute", "lbvh", "cluster")
WORLD = 2   # test_torch_geometry_sharding4.py runs these tests at 4


def _arrays(o):
    if o is None:
        return None
    if isinstance(o, list):
        return o
    out = {}
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        out[f.name] = (_arrays(v) if dataclasses.is_dataclass(v)
                       else v if v is None or isinstance(v, (str, int, bool))
                       else np.asarray(v))
    return out


@pytest.fixture(scope="module")
def setup():
    verts, faces = random_triangles(64, seed=2, extent=3.0, tri_size=0.8)
    gids = np.arange(64, dtype=np.int32) % 5
    jm = JMesh.create(verts, faces, geom_ids=gids)
    rng = np.random.default_rng(3)
    cent = verts.reshape(-1, 3, 3).mean(axis=1)
    o = rng.uniform(-2.5, 2.5, (128, 3)).astype(np.float32)
    d = (cent[rng.integers(0, len(cent), 128)] - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return verts, faces, gids, jm, o, d


def _jax_side(jm, o, d, D, backend):
    """JAX's closest hits with their gradient (one trace), and its any
    hits at two max_t (one jitted function)."""
    mesh = jmake_mesh(D)
    geo = jring.shard_geometry(jm, D, backend=backend)
    ray = JRay(jnp.asarray(o), jnp.asarray(d))
    interp = backend == "cluster"

    def loss(v1, e1, e2):
        geo2 = dataclasses.replace(geo, soup=dataclasses.replace(
            geo.soup, v1=v1, e1=e1, e2=e2))
        h = jring.geometry_sharded_closest_hit(ray, geo2, mesh,
                                               interpret=interp)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0)), h

    (_, hr), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                has_aux=True))(
        geo.soup.v1, geo.soup.e1, geo.soup.e2)
    any_hit = jax.jit(lambda mt: jring.geometry_sharded_any_hit(
        ray, mt, geo, mesh, interpret=interp).hit)
    tmax = jnp.where(hr.hit, hr.t * 0.9, 1e30)
    return geo, {"hit": np.asarray(hr.hit), "t": np.asarray(hr.t),
                 "prim": np.asarray(hr.prim_id),
                 "geom": np.asarray(hr.geom_id),
                 "any": np.asarray(any_hit(jnp.full_like(tmax, 1e30))),
                 "any09": np.asarray(any_hit(tmax)),
                 "tmax": np.asarray(tmax),
                 "g": [np.asarray(g) for g in grads]}


_BODY = """
from visionaray_torch import convert
from visionaray_torch.core.types import Ray
from visionaray_torch.parallel.comm import world_mesh
from visionaray_torch.parallel import ring
mesh = world_mesh()
for backend in ("brute", "lbvh", "cluster"):
    geo = convert.sharded_geometry_from_arrays(INP[backend], device="cpu")
    leaves = [geo.soup.v1.requires_grad_(), geo.soup.e1.requires_grad_(),
              geo.soup.e2.requires_grad_()]
    ray = Ray(torch.as_tensor(INP["o"]), torch.as_tensor(INP["d"]))
    hr = ring.geometry_sharded_closest_hit(ray, geo, mesh)
    torch.where(hr.hit, hr.t, 0.0).sum().backward()
    with torch.no_grad():
        ah = ring.geometry_sharded_any_hit(ray, 1e30, geo, mesh)
        ah2 = ring.geometry_sharded_any_hit(
            ray, torch.as_tensor(INP[backend + "_tmax"]), geo, mesh)
    for k, v in (("hit", hr.hit), ("t", hr.t), ("prim", hr.prim_id),
                 ("geom", hr.geom_id), ("any", ah.hit), ("any09", ah2.hit),
                 ("g0", leaves[0].grad), ("g1", leaves[1].grad),
                 ("g2", leaves[2].grad)):
        OUT[backend + "_" + k] = v.detach().numpy()
"""


def make_runs(D):
    """The module's fixture: JAX on make_mesh(D), the port on D ranks."""
    @pytest.fixture(scope="module")
    def runs(setup, tmp_path_factory):
        _, _, _, jm, o, d = setup
        jax_out, inputs = {}, {"o": o, "d": d}
        for b in BACKENDS:
            geo, jax_out[b] = _jax_side(jm, o, d, D, b)
            inputs[b] = _arrays(geo)
            inputs[b + "_tmax"] = jax_out[b]["tmax"]
        outs = run_ranks(tmp_path_factory.mktemp(f"geo{D}"), D, _BODY,
                         inputs)
        return D, jax_out, outs, {b: inputs[b] for b in BACKENDS}
    return runs


runs = make_runs(2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_geometry_equals_jax(setup, backend):
    verts, faces, gids, jm, _, _ = setup
    for D in (2, 4):
        jgeo = jring.shard_geometry(jm, D, backend=backend)
        tm = TriangleMesh.create(verts, faces, geom_ids=gids, device=CPU)
        geo = tring.shard_geometry(tm, D, backend=backend)
        assert geo.prims_per_shard == jgeo.prims_per_shard
        np.testing.assert_array_equal(geo.prim_ids.numpy(),
                                      np.asarray(jgeo.prim_ids))
        for a, b in ((geo.shard_lo, jgeo.shard_lo),
                     (geo.shard_hi, jgeo.shard_hi),
                     (geo.soup.v1, jgeo.soup.v1),
                     (geo.soup.e1, jgeo.soup.e1)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if backend == "brute":
            assert geo.bvh is None
            continue
        for i in range(D):
            if backend == "lbvh":
                for f in ("node_lo", "node_hi", "left", "right",
                          "prim_ids"):
                    np.testing.assert_array_equal(
                        getattr(geo.bvh[i], f).numpy(),
                        np.asarray(getattr(jgeo.bvh, f))[i])
            else:
                np.testing.assert_array_equal(
                    geo.bvh[i].nodes.numpy(), np.asarray(jgeo.bvh.nodes)[i])
                np.testing.assert_array_equal(
                    geo.bvh[i].tris.numpy(), np.asarray(jgeo.bvh.tris)[i])


@pytest.mark.parametrize("backend", BACKENDS)
def test_closest_hits_match_jax(runs, backend):
    D, jax_out, outs, geos = runs
    ref = jax_out[backend]
    for out in outs:   # every rank holds the whole result
        got = {k: out[f"{backend}_{k}"] for k in ("hit", "t", "prim",
                                                   "geom")}
        np.testing.assert_array_equal(got["hit"], ref["hit"])
        m = ref["hit"]
        assert m.sum() > 20
        np.testing.assert_allclose(got["t"][m], ref["t"][m], rtol=1e-5)
        np.testing.assert_array_equal(got["geom"][m], ref["geom"][m])
        pids = geos[backend]["prim_ids"].reshape(-1)
        np.testing.assert_array_equal(pids[got["prim"][m]],
                                      pids[ref["prim"][m]])


@pytest.mark.parametrize("backend", BACKENDS)
def test_any_hits_match_jax(runs, backend):
    D, jax_out, outs, _ = runs
    ref = jax_out[backend]
    for out in outs:
        np.testing.assert_array_equal(out[f"{backend}_any"], ref["any"])
        np.testing.assert_array_equal(out[f"{backend}_any09"],
                                      ref["any09"])
        assert not out[f"{backend}_any09"][ref["hit"]].any()


def _unsharded_grads(setup):
    """The port's brute-force sweep over the whole mesh: d sum(t over
    hits) / d (v1, e1, e2), in face order."""
    verts, faces, gids, _, o, d = setup
    tm = TriangleMesh.create(verts, faces, geom_ids=gids, device=CPU)
    leaves = [c.detach().clone().requires_grad_() for c in tm.corners()]
    hr = intersect_triangles_brute(Ray(torch.as_tensor(o), torch.as_tensor(d)),
                                   *leaves, tm.geom_ids)
    torch.where(hr.hit, hr.t, 0.0).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("backend", BACKENDS)
def test_soup_gradients_match_jax(runs, setup, backend):
    """Each rank's soup gradient lands on its own shard (the hops'
    backward carries the other ranks' rays' share to it); their sum,
    scattered to the faces, is JAX's gradient scattered alike."""
    D, jax_out, outs, geos = runs
    pids = torch.as_tensor(np.array(geos[backend]["prim_ids"]))
    unsharded = _unsharded_grads(setup)
    for k in range(3):
        got = sum(out[f"{backend}_g{k}"] for out in outs)
        ref = jax_out[backend]["g"][k]
        assert np.isfinite(got).all()
        assert np.abs(ref).max() > 0
        for r, out in enumerate(outs):
            others = np.delete(out[f"{backend}_g{k}"], r, axis=0)
            assert not others.any(), "a rank wrote another shard's gradient"
        a = soup_grads_to_faces(torch.as_tensor(got), pids, 64).numpy()
        b = soup_grads_to_faces(torch.as_tensor(ref), pids, 64).numpy()
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= 5e-4, rel
        close = np.isclose(a, unsharded[k], rtol=1e-4, atol=1e-6)
        assert close.mean() > 0.97, close.mean()
