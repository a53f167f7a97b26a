"""Config #5 on the CPU: the port's geometry-sharded path tracer
(parallel/sharded_pt.py) against the JAX package's, at 2 ranks here and
at 4 in test_torch_sharded_render4.py (tests/test_sharded_render.py's
set-up: the Cornell box with an area light over its emissive patch,
40 x 40, 3 bounces).

JAX renders on ``make_mesh(D)`` (the cluster backend's kernel in
interpret mode); its ``ShardedGeometry`` (with shading data), materials,
lights and camera go to D gloo ranks through ``convert`` (the harness of
tests/test_torch_multihost.py).  Frames are held to JAX's own test's
rule (more than 99.5% of channels within atol 2e-3, rtol 1e-4; means
within rtol 5e-3: an exact tie between coincident faces may pick another
face).  Also here: ``soup_grads_to_faces`` against JAX's on the same
gradients, and a ring in which one rank's rays all miss (no live lanes)
yet its hops take part in every rank's ``backward()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.parallel import ring as jring
from visionaray_tpu.parallel import sharded_pt as jspt
from visionaray_tpu.parallel.tile_sharding import make_mesh as jmake_mesh
from visionaray_tpu.scenes import cornell_box
from visionaray_tpu.shading.lights import AreaLights

from test_torch_geometry_sharding import _arrays
from test_torch_multihost import run_ranks
from visionaray_torch.parallel import sharded_pt as tspt

torch.set_num_threads(1)
W = H = 40
BOUNCES = 3
EPS = 1e-3
BG = (0.1, 0.4, 1.0, 1.0)
AMB = (1.0, 1.0, 1.0)
# (backend, nee) frames of this file's world size
FRAMES = (("brute", True), ("lbvh", True), ("cluster", True),
          ("brute", False))


@pytest.fixture(scope="module")
def cornell_nee():
    scene, cam = cornell_box()
    s = 5.55
    l0, l1, ly = 0.35 * s, 0.65 * s, s - 0.005 * s
    al = AreaLights.rect(corner=(l0, ly, l0), edge1=(l1 - l0, 0, 0),
                         edge2=(0, 0, l1 - l0), cl=(1.0, 0.85, 0.6), kl=8.0)
    return dataclasses.replace(scene, lights=al), cam


def scene_inputs(scene, cam):
    return {"materials": _arrays(scene.materials),
            "lights": _arrays(scene.lights), "cam": _arrays(cam)}


def assert_images_match(a, b):
    close = np.isclose(a, b, atol=2e-3, rtol=1e-4)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=5e-3)


_BODY = """
from visionaray_torch import convert
from visionaray_torch.parallel.comm import world_mesh
from visionaray_torch.parallel.sharded_pt import render_image_geometry_sharded
mesh = world_mesh()
mats = convert.materials_from_arrays(INP["materials"], device="cpu")
lights = convert.lights_from_arrays("AreaLights", INP["lights"], device="cpu")
cam = convert.pinhole_from_arrays(INP["cam"], device="cpu")
for key in INP["frames"]:
    backend, nee = str(key).split("_")
    geo = convert.sharded_geometry_from_arrays(INP[backend], device="cpu",
                                               shards=(RANK,))
    color, depth = render_image_geometry_sharded(
        geo, mats, lights, cam, 40, 40, mesh, num_bounces=3, spp=1,
        eps=1e-3, bg_color=(0.1, 0.4, 1.0, 1.0), ambient=(1.0, 1.0, 1.0),
        frame_num=1, seed=0, nee=nee == "1")
    OUT[key] = color.numpy()
    OUT[key + "_soup_bytes"] = np.array(sum(
        x.numel() * x.element_size() for x in (
            geo.soup.v1, geo.soup.e1, geo.soup.e2, geo.soup.geom_ids)))
"""


def make_frames(D):
    """JAX's frames on make_mesh(D) and the port's on D ranks."""
    @pytest.fixture(scope="module")
    def frames(cornell_nee, tmp_path_factory):
        scene, cam = cornell_nee
        mesh = jmake_mesh(D)
        inputs = scene_inputs(scene, cam)
        ref, keys = {}, []
        for backend, nee in FRAMES:
            geo = jring.shard_geometry(scene.mesh, D, backend=backend,
                                       with_shading=True)
            inputs[backend] = _arrays(geo)
            color, _ = jax.jit(
                lambda g, m, lt, b=backend, nee=nee:
                jspt.render_image_geometry_sharded(
                    g, m, lt, cam, W, H, mesh, num_bounces=BOUNCES, spp=1,
                    eps=EPS, bg_color=BG, ambient=AMB, frame_num=1, seed=0,
                    nee=nee, interpret=b == "cluster"))(
                geo, scene.materials, scene.lights)
            key = f"{backend}_{int(nee)}"
            ref[key] = np.asarray(color)
            keys.append(key)
        inputs["frames"] = np.array(keys)
        outs = run_ranks(tmp_path_factory.mktemp(f"spt{D}"), D, _BODY,
                         inputs)
        return D, ref, outs, scene.mesh.num_prims
    return frames


frames = make_frames(2)


@pytest.mark.parametrize("backend,nee", FRAMES)
def test_frame_matches_jax(frames, backend, nee):
    D, ref, outs, F = frames
    key = f"{backend}_{int(nee)}"
    assert ref[key][..., :3].mean() > 0.01   # lit
    for out in outs:   # every rank returns the whole frame
        assert np.isfinite(out[key]).all()
        assert_images_match(out[key], ref[key])
    # each rank holds one shard: ceil(F / D) triangles of soup
    per = -(-F // D)
    assert int(outs[0][key + "_soup_bytes"]) == per * (3 * 3 * 4 + 4)


def test_soup_grads_to_faces_equals_jax():
    rng = np.random.default_rng(7)
    g = rng.normal(size=(4, 10, 3, 3)).astype(np.float32)
    ids = np.concatenate([rng.permutation(37), [36, 36, 36]]).astype(
        np.int32).reshape(4, 10)
    got = tspt.soup_grads_to_faces(torch.as_tensor(g), torch.as_tensor(ids),
                                   37)
    ref = jspt.soup_grads_to_faces(jnp.asarray(g), jnp.asarray(ids), 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


_BODY_DEAD = """
from visionaray_torch import convert
from visionaray_torch.core.types import Ray
from visionaray_torch.parallel import comm, ring
mesh = comm.world_mesh()
geo = convert.sharded_geometry_from_arrays(INP["geo"], device="cpu",
                                           shards=(RANK,))
leaves = [geo.soup.v1.requires_grad_(), geo.soup.e1.requires_grad_(),
          geo.soup.e2.requires_grad_()]
ray = Ray(torch.as_tensor(INP["o"]), torch.as_tensor(INP["d"]))
comm.reset_stats()
hr = ring.geometry_sharded_closest_hit(ray, geo, mesh)
fwd_hops = comm.STATS["hops"]
torch.where(hr.hit, hr.t, 0.0).sum().backward()
OUT["hops"] = np.array([fwd_hops, comm.STATS["hops"]])
OUT["hit"] = hr.hit.numpy()
for k in range(3):
    OUT[f"g{k}"] = leaves[k].grad.numpy()
"""


def test_rank_without_live_lanes_takes_part_in_backward(cornell_nee,
                                                         tmp_path):
    """Two ranks; the second rank's block of rays points away from the
    box, so it traces no lane of its own, yet its hops carry the first
    rank's rays and their gradients: each rank runs 2 hops forward and 2
    backward, and the soup gradients, summed, are JAX's."""
    scene, _ = cornell_nee
    geo = jring.shard_geometry(scene.mesh, 2, backend="brute")
    rng = np.random.default_rng(11)
    o = np.tile(np.array([[2.775, 2.775, -8.0]], np.float32), (64, 1))
    tgt = rng.uniform(0.5, 5.0, (64, 3)).astype(np.float32)
    d = tgt - o
    d[32:] = -d[32:]   # rank 1's block: away from the box
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = JRay(jnp.asarray(o), jnp.asarray(d))
    mesh = jmake_mesh(2)

    def loss(v1, e1, e2):
        g2 = dataclasses.replace(geo, soup=dataclasses.replace(
            geo.soup, v1=v1, e1=e1, e2=e2))
        h = jring.geometry_sharded_closest_hit(ray, g2, mesh)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0)), h

    (_, jh), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True))(
        geo.soup.v1, geo.soup.e1, geo.soup.e2)
    outs = run_ranks(tmp_path, 2, _BODY_DEAD,
                     {"geo": _arrays(geo), "o": o, "d": d})
    assert np.asarray(jh.hit)[:32].all() and not np.asarray(jh.hit)[32:].any()
    for out in outs:
        np.testing.assert_array_equal(out["hit"], np.asarray(jh.hit))
        assert out["hops"].tolist() == [2, 4]
    for k in range(3):
        got = np.stack([outs[r][f"g{k}"][0] for r in range(2)])
        ref = np.asarray(jg[k])
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
