"""Public names the port took over last from the JAX package (the
viewer's scheduler parameters, render targets, light sampling, cluster
constants, BRDF helpers, vector constructors), each against its JAX
counterpart on the same numpy inputs; the package's top-level exports
against JAX's; and the port's example scripts free of JAX."""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visionaray_torch
import visionaray_tpu
from visionaray_tpu.core import vecmath as jvec
from visionaray_tpu.ops.pallas import cluster_bvh as jcb
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading import brdf as jbrdf
from visionaray_tpu.shading import lights as jlights

from visionaray_torch.core import vecmath as tvec
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.ops import cluster_bvh as tcb
from visionaray_torch.sched import render as trender
from visionaray_torch.shading import brdf as tbrdf
from visionaray_torch.shading import lights as tlights

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(21)


def test_top_level_exports_match_jax():
    assert set(visionaray_tpu.__all__) <= set(visionaray_torch.__all__)
    assert set(visionaray_torch.__all__) - set(visionaray_tpu.__all__) \
        == {"resolve_device"}
    for name in visionaray_torch.__all__:
        assert hasattr(visionaray_torch, name)


def test_sched_params_matches_jax():
    j, t = jrender.SchedParams(), trender.SchedParams()
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == {f.name: getattr(j, f.name)
                                     for f in dataclasses.fields(j)}
    assert trender.SchedParams(algo="pathtracing", spp=4).spp == 4


def test_render_target_create_matches_jax():
    j = jrender.RenderTarget.create(7, 5)
    t = trender.RenderTarget.create(7, 5, device="cpu")
    assert (t.width, t.height) == (j.width, j.height)
    for f in ("color", "depth"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))


def _lights():
    pos = RNG.normal(size=(3, 3)).astype(np.float32)
    v1 = RNG.normal(size=(2, 3)).astype(np.float32)
    e1 = RNG.normal(size=(2, 3)).astype(np.float32)
    e2 = RNG.normal(size=(2, 3)).astype(np.float32)
    return ((jlights.PointLights.create(position=pos),
             tlights.PointLights.create(position=pos, device="cpu")),
            (jlights.SpotLights.create(position=pos, direction=-pos),
             tlights.SpotLights.create(position=pos, direction=-pos,
                                       device="cpu")),
            (jlights.AreaLights.create(v1, e1, e2),
             tlights.AreaLights.create(v1, e1, e2, device="cpu")))


def test_light_sample_matches_jax():
    u1 = RNG.uniform(size=16).astype(np.float32)
    u2 = RNG.uniform(size=16).astype(np.float32)
    for j, t in _lights():
        for li in range(t.num_lights):
            np.testing.assert_allclose(t.sample(li).numpy(),
                                       np.asarray(j.sample(li)), atol=1e-6)
            np.testing.assert_allclose(
                t.sample(li, torch.as_tensor(u1), torch.as_tensor(u2))
                .numpy(), np.asarray(j.sample(li, jnp.asarray(u1),
                                              jnp.asarray(u2))), atol=1e-6)
    # area lights without uniforms sample their centroid
    _, _, (_, area) = _lights()
    np.testing.assert_allclose(area.sample(1).numpy(),
                               area.position[1].numpy(), atol=0)


def test_cluster_names_match_jax():
    assert tcb.DEFAULT_CLUSTER_SIZE == jcb.DEFAULT_CLUSTER_SIZE
    assert tcb.DEFAULT_TREELET_SIZE == jcb.DEFAULT_TREELET_SIZE
    verts = RNG.normal(size=(60, 3)).astype(np.float32)
    faces = RNG.integers(0, 60, (50, 3)).astype(np.int32)
    from visionaray_tpu.core.scene import TriangleMesh as JMesh
    jb = jcb.build_cluster_bvh(JMesh.create(verts, faces), cluster_size=8)
    tb = tcb.build_cluster_bvh(TriangleMesh.create(verts, faces,
                                                   device="cpu"),
                               cluster_size=8)
    assert tb.num_prims == jb.num_prims == 56
    for n in (1, 1000, 100_000, 1_000_000):
        assert tcb.pick_cluster_size(n) == jcb.pick_cluster_size(n)


def test_cluster_build_from_corners_matches_jax():
    verts = RNG.normal(size=(90, 3)).astype(np.float32)
    faces = RNG.integers(0, 90, (70, 3)).astype(np.int32)
    from visionaray_tpu.core.scene import TriangleMesh as JMesh
    jm = JMesh.create(verts, faces)
    tm = TriangleMesh.create(verts, faces, device="cpu")
    for treelet in (0, 2):
        jb = jcb.build_cluster_bvh_from_corners(*jm.corners(),
                                                cluster_size=8,
                                                treelet_size=treelet)
        tb = tcb.build_cluster_bvh_from_corners(*tm.corners(),
                                                cluster_size=8,
                                                treelet_size=treelet)
        np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
        np.testing.assert_array_equal(tb.tris.numpy(), np.asarray(jb.tris))


def test_cluster_build_refuses_2_24_prims():
    big = torch.zeros((1 << 24, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="2\\^24"):
        tcb.build_cluster_bvh_from_corners(big, big, big, cluster_size=8)


def test_brdf_names_match_jax():
    u1 = RNG.uniform(size=32).astype(np.float32)
    u2 = RNG.uniform(size=32).astype(np.float32)
    np.testing.assert_allclose(
        tbrdf.uniform_sample_hemisphere(torch.as_tensor(u1),
                                        torch.as_tensor(u2)).numpy(),
        np.asarray(jbrdf.uniform_sample_hemisphere(jnp.asarray(u1),
                                                   jnp.asarray(u2))),
        atol=1e-6)
    eta = RNG.uniform(1.1, 2.0, 32).astype(np.float32)
    cosi = RNG.uniform(0.1, 1.0, 32).astype(np.float32)
    cost = RNG.uniform(0.1, 1.0, 32).astype(np.float32)
    np.testing.assert_allclose(
        tbrdf.fresnel_reflectance_dielectric(
            *[torch.as_tensor(a) for a in (eta, cosi, cost)]).numpy(),
        np.asarray(jbrdf.fresnel_reflectance_dielectric(
            *[jnp.asarray(a) for a in (eta, cosi, cost)])), rtol=1e-6)
    n = RNG.normal(size=(32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wo = RNG.normal(size=(32, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = RNG.normal(size=(32, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    cs = RNG.uniform(size=(32, 3)).astype(np.float32)
    ks = RNG.uniform(size=32).astype(np.float32)
    ex = RNG.uniform(1.0, 64.0, 32).astype(np.float32)
    args = (cs, ks, ex, n, wo, wi)
    np.testing.assert_allclose(
        tbrdf.phong_f(*[torch.as_tensor(a) for a in args]).numpy(),
        np.asarray(jbrdf.phong_f(*[jnp.asarray(a) for a in args])),
        rtol=1e-5, atol=1e-7)


def test_vec_constructors_match_jax():
    np.testing.assert_array_equal(tvec.vec3(1, 2, 3).numpy(),
                                  np.asarray(jvec.vec3(1, 2, 3)))
    np.testing.assert_array_equal(tvec.vec4(1, 2, 3, 4).numpy(),
                                  np.asarray(jvec.vec4(1, 2, 3, 4)))
    assert tvec.vec3(1, 2, 3).dtype == torch.float32


def test_port_examples_import_no_jax():
    paths = sorted(os.path.join(REPO, "examples", f)
                   for f in os.listdir(os.path.join(REPO, "examples"))
                   if f.startswith("torch_") and f.endswith(".py"))
    assert len(paths) == 6, paths
    for p in paths:
        text = open(p).read()
        for line in text.splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not re.search(r"\bjax\b|visionaray_tpu", s), \
                    f"{p}: {line}"
