"""Gradients of the geometry-sharded path tracer against ``jax.grad`` of
the JAX package's, at 2 ranks here and at 4 in
test_torch_sharded_grad4.py (tests/test_sharded_render.py's
``test_grads_flow_to_shards`` set-up: the Cornell box with its area
light, 40 x 40, 2 bounces, NEE, brute-force shards).

The loss is the mean of the frame's colour.  On each rank ``backward()``
of that loss leaves the soup gradients of its own shard (the hops carry
the other ranks' rays' share to it) and its share of the replicated
materials' gradient, which ``all_reduce_grads`` sums.  The soup
gradients, scattered to faces with ``soup_grads_to_faces``, and the
albedo ``cd``'s must be within relative L2 1e-3 of JAX's, at a cosine of
at least 0.999 (PERF.md section 2's gradient rule), all finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.parallel import ring as jring
from visionaray_tpu.parallel import sharded_pt as jspt
from visionaray_tpu.parallel.tile_sharding import make_mesh as jmake_mesh

from test_torch_geometry_sharding import _arrays
from test_torch_multihost import run_ranks
from test_torch_sharded_render import (  # noqa: F401
    AMB, BG, EPS, H, W, cornell_nee, scene_inputs,
)
from visionaray_torch.parallel.sharded_pt import soup_grads_to_faces

torch.set_num_threads(1)
FIELDS = ("v1", "e1", "e2", "corner_normals")

_BODY = """
from visionaray_torch import convert
from visionaray_torch.parallel.comm import world_mesh
from visionaray_torch.parallel.sharded_pt import render_image_geometry_sharded
from visionaray_torch.parallel.tile_sharding import all_reduce_grads
mesh = world_mesh()
mats = convert.materials_from_arrays(INP["materials"], device="cpu")
mats.cd.requires_grad_()
lights = convert.lights_from_arrays("AreaLights", INP["lights"], device="cpu")
cam = convert.pinhole_from_arrays(INP["cam"], device="cpu")
geo = convert.sharded_geometry_from_arrays(INP["geo"], device="cpu",
                                           shards=(RANK,))
fields = ("v1", "e1", "e2", "corner_normals")
for f in fields:
    getattr(geo.soup, f).requires_grad_()
color, _ = render_image_geometry_sharded(
    geo, mats, lights, cam, 40, 40, mesh, num_bounces=2, spp=1, eps=1e-3,
    bg_color=(0.1, 0.4, 1.0, 1.0), ambient=(1.0, 1.0, 1.0), frame_num=1,
    seed=0, nee=True)
loss = color[..., :3].mean()
loss.backward()
all_reduce_grads([mats.cd], mesh)
OUT["loss"] = loss.detach().numpy()
OUT["cd"] = mats.cd.grad.numpy()
for f in fields:
    OUT[f] = getattr(geo.soup, f).grad.numpy()
"""


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cos(a, b):
    a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def make_grads(D):
    @pytest.fixture(scope="module")
    def grads(cornell_nee, tmp_path_factory):
        scene, cam = cornell_nee
        geo = jring.shard_geometry(scene.mesh, D, backend="brute",
                                   with_shading=True)
        mesh = jmake_mesh(D)

        def loss(leaves, cd):
            soup = dataclasses.replace(geo.soup, **leaves)
            mats = dataclasses.replace(scene.materials, cd=cd)
            color, _ = jspt.render_image_geometry_sharded(
                dataclasses.replace(geo, soup=soup), mats, scene.lights,
                cam, W, H, mesh, num_bounces=2, spp=1, eps=EPS,
                bg_color=BG, ambient=AMB, frame_num=1, seed=0, nee=True)
            return jnp.mean(color[..., :3])

        leaves = {f: getattr(geo.soup, f) for f in FIELDS}
        val, (gl, gcd) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
            leaves, scene.materials.cd)
        inputs = scene_inputs(scene, cam)
        inputs["geo"] = _arrays(geo)
        outs = run_ranks(tmp_path_factory.mktemp(f"grad{D}"), D, _BODY,
                         inputs)
        ref = {f: np.asarray(gl[f]) for f in FIELDS}
        ref["cd"], ref["loss"] = np.asarray(gcd), float(val)
        return geo, ref, outs, scene.mesh.num_prims
    return grads


grads = make_grads(2)


def test_loss_matches_jax(grads):
    _, ref, outs, _ = grads
    for out in outs:   # every rank sees the whole frame's loss
        np.testing.assert_allclose(float(out["loss"]), ref["loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("field", FIELDS)
def test_soup_gradient_matches_jax(grads, field):
    geo, ref, outs, F = grads
    got = np.concatenate([out[field] for out in outs])   # shard r of rank r
    pids = torch.as_tensor(np.array(geo.prim_ids))
    a = soup_grads_to_faces(torch.as_tensor(got), pids, F).numpy()
    b = soup_grads_to_faces(torch.as_tensor(ref[field]), pids, F).numpy()
    assert np.isfinite(a).all() and np.abs(b).max() > 0
    assert rel_l2(a, b) <= 1e-3, rel_l2(a, b)
    assert cos(a, b) >= 0.999


def test_replicated_material_gradient_matches_jax(grads):
    _, ref, outs, _ = grads
    for out in outs:   # all-reduced: the same sum on every rank
        assert np.isfinite(out["cd"]).all()
        assert rel_l2(out["cd"], ref["cd"]) <= 1e-3
        assert cos(out["cd"], ref["cd"]) >= 0.999
