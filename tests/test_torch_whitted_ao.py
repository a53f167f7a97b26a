"""The port's Whitted and AO kernels, ``Materials.specular_bounce`` and
``scenes/basic.py`` against the JAX package on the CPU.

- ``render(algo="whitted")`` and ``render(algo="ao")`` with render's
  defaults on test_golden_whitted.py's mixed scene (plastic triangle,
  mirror sphere, matte plane; carried over with convert.py), against JAX
  at test_torch_simple.py's image tolerance (mean abs <= 1e-4, at most 2%
  of pixels off by more than 1e-3) and depths to rtol 1e-5 (AO's jittered
  rays: 1e-4, where grazing hits on the plane at t ~ 3e3 scale a last-ulp
  difference of the ray direction by ~30); the Whitted
  frame also against tests/oracle.py's scalar render_whitted at that
  test's tolerance (under 1% of pixels off by more than 2e-3).  The mirror
  sphere is what tells the first segment's background (no-hit scale 1)
  from the later segments' black.
- Both kernels on sponza_like(2000) with a radix-tree ClusterBVH (K=8),
  each package building its own scene and tree, at the image tolerance:
  the Whitted frame launches 5 radix closest-hit and 4 radix any-hit
  traversals, the AO frame 1 and 8 (on the CPU the wrapper's plain
  version; JAX's Pallas kernel in interpret mode).
- The vertex gradient of a Whitted loss at 16x16 on the mixed scene
  against ``jax.grad``: relative L2 <= 1e-3.
- ``specular_bounce`` per material type: direction to 1e-6, kr exact.
- ``scenes/basic.py`` against JAX's, array by array: inputs exact, the
  normals derived from them to 1e-7 (one f32 ulp of a unit vector).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from visionaray_tpu.core.camera import Pinhole as JPinhole
from visionaray_tpu.core.scene import Planes as JPlanes
from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.core.scene import Spheres as JSpheres
from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.scenes import basic as jbasic
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading.lights import PointLights as JPointLights
from visionaray_tpu.shading.materials import Materials as JMaterials

from visionaray_torch import convert
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.scenes import basic as tbasic
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender
from visionaray_torch.shading.materials import Materials

torch.set_num_threads(1)
CPU = "cpu"
W = H = 48


def _image_close(got, ref):
    """test_torch_simple.py's image tolerance."""
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


def _arrays(o):
    return {f.name: (getattr(o, f.name) if f.name == "face_normals_binding"
                     else np.asarray(getattr(o, f.name)))
            for f in dataclasses.fields(o)}


TRI_V = np.array([[-1.5, 0.0, -1.0], [-0.2, 0.0, -1.2], [-0.85, 1.6, -1.1]],
                 np.float32)


def _jax_mixed(verts=TRI_V):
    """test_golden_whitted.py's scene: plastic triangle, mirror sphere,
    matte plane, one point light."""
    mesh = JMesh.create(verts, np.array([[0, 1, 2]], np.int32),
                        geom_ids=[0])
    materials = JMaterials.concatenate([
        JMaterials.plastic(cd=(0.8, 0.2, 0.1), kd=1.0, cs=(0.2, 0.2, 0.2),
                           ks=1.0, specular_exp=32.0, ca=(0.2, 0.2, 0.2),
                           ka=1.0),
        JMaterials.mirror(cr=(0.9, 0.9, 0.9), kr=0.9),
        JMaterials.matte(cd=(0.6, 0.6, 0.6), kd=1.0, ca=(0.2, 0.2, 0.2),
                         ka=1.0),
    ])
    scene = JScene.create(
        mesh=mesh, materials=materials,
        spheres=JSpheres.create(center=[[0.8, 0.6, 0.0]], radius=[0.6],
                                geom_ids=[1]),
        planes=JPlanes.create(normal=[[0.0, 1.0, 0.0]], offset=[0.0],
                              geom_ids=[2]),
        lights=JPointLights.create(position=[[2.0, 5.0, 3.0]]))
    cam = JPinhole.create(eye=(0.0, 1.5, 4.0), center=(0.0, 0.8, 0.0),
                          up=(0.0, 1.0, 0.0), fovy=np.deg2rad(45.0),
                          aspect=1.0)
    return scene, cam


def _to_torch(js, jcam):
    ts = convert.scene_from_arrays(
        mesh=_arrays(js.mesh), spheres=_arrays(js.spheres),
        planes=_arrays(js.planes), materials=_arrays(js.materials),
        lights=(type(js.lights).__name__, _arrays(js.lights)), device=CPU)
    return ts, convert.pinhole_from_arrays(_arrays(jcam), device=CPU)


@pytest.fixture(scope="module")
def mixed():
    js, jcam = _jax_mixed()
    return (js, jcam) + _to_torch(js, jcam)


@pytest.mark.parametrize("algo", ["whitted", "ao"])
def test_mixed_scene_matches_jax(mixed, algo):
    js, jcam, ts, tcam = mixed
    jrt = jrender.render(js, jcam, W, H, algo=algo)
    trt = trender.render(ts, tcam, W, H, algo=algo)
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5 if algo == "whitted" else 1e-4)
    if algo == "whitted":
        # the mirror sphere shows the plane and the sky: reflections of the
        # background must be black after the first segment, lit elsewhere
        assert trt.color[..., :3].std() > 0.05


def test_whitted_matches_oracle(mixed):
    """As test_golden_whitted.py holds the JAX package."""
    js, jcam, ts, tcam = mixed
    rt = trender.render(ts, tcam, W, H, algo="whitted", bounces=4,
                        epsilon=1e-3, ambient=(0.0, 0.0, 0.0, 0.0))
    ref = oracle.render_whitted(oracle.scene_to_np(js),
                                oracle.cam_to_np(jcam), W, H, bounces=4,
                                epsilon=1e-3)
    diff = np.abs(rt.color.numpy() - ref.astype(np.float32))
    assert np.mean(np.any(diff > 2e-3, axis=-1)) < 0.01


def test_ao_progressive_blend_matches_jax(mixed):
    """AO's jittered_blend sampler and the rt blend at frame_num=2."""
    js, jcam, ts, tcam = mixed
    jrt = jrender.render(js, jcam, 24, 24, algo="ao", frame_num=1)
    jrt = jrender.render(js, jcam, 24, 24, algo="ao", frame_num=2, rt=jrt)
    trt = trender.render(ts, tcam, 24, 24, algo="ao", frame_num=1)
    trt = trender.render(ts, tcam, 24, 24, algo="ao", frame_num=2, rt=trt)
    _image_close(trt.color.numpy(), jrt.color)


@pytest.fixture(scope="module")
def radix_scenes():
    js, jcam = j_sponza(target_tris=2000, build_bvh=False)
    js = dataclasses.replace(js, bvh=jbuild(js.mesh, cluster_size=8,
                                            treelet_size=0))
    ts, tcam = sponza_like_scene(target_tris=2000, device=CPU)
    ts.bvh = build_cluster_bvh(ts.mesh, cluster_size=8, treelet_size=0)
    assert not ts.bvh.heap and ts.bvh.num_clusters == js.bvh.num_clusters
    return js, jcam, ts, tcam


@pytest.mark.parametrize("algo,closest,anyhit",
                         [("whitted", 5, 4), ("ao", 1, 8)])
def test_radix_tree_matches_jax(radix_scenes, algo, closest, anyhit,
                                monkeypatch):
    js, jcam, ts, tcam = radix_scenes
    Wr, Hr = 24, 16
    jrt = jrender.render(js, jcam, Wr, Hr, algo=algo)

    seen = []
    real = trav.cluster_traverse

    def spy(*a, **k):
        seen.append(trav.launch_mode(k.get("heap", True), a[3],
                                     k.get("tile_roots") is not None,
                                     k.get("any_hit", False)))
        return real(*a, **k)

    monkeypatch.setattr(trav, "cluster_traverse", spy)
    trt = trender.render(ts, tcam, Wr, Hr, algo=algo)
    assert seen.count("radix_closest") == closest
    assert seen.count("radix_any") == anyhit and len(seen) == closest + anyhit
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5)
    assert trt.color[..., :3].std() > 0.01


def _weights(n):
    return np.linspace(0.5, 1.5, n, dtype=np.float32)[None, :, None]


def test_whitted_vertex_gradient_matches_jax():
    """d loss / d vertices of a 16x16 Whitted frame, the loss a weighted
    mean of the RGB (the triangle is also seen in the mirror sphere)."""
    n = 16
    wgt = _weights(n)

    def jloss(v):
        js, jcam = _jax_mixed(v)
        rt = jrender.render(js, jcam, n, n, algo="whitted", epsilon=1e-3)
        return jnp.mean(rt.color[..., :3] * wgt)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(TRI_V)))

    js, jcam = _jax_mixed()
    ts, tcam = _to_torch(js, jcam)
    v = torch.tensor(TRI_V, requires_grad=True)
    mesh = TriangleMesh.create(v, ts.mesh.faces, geom_ids=ts.mesh.geom_ids,
                               device=CPU)
    rt = trender.render(dataclasses.replace(ts, mesh=mesh), tcam, n, n,
                        algo="whitted", epsilon=1e-3)
    loss = torch.mean(rt.color[..., :3] * torch.from_numpy(wgt))
    (g,) = torch.autograd.grad(loss, v)
    g = g.double().numpy()
    assert np.abs(g_ref).sum() > 0
    rel = np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
    assert rel <= 1e-3, (rel, g, g_ref)


def test_specular_bounce_per_type():
    rng = np.random.default_rng(5)
    view = rng.normal(size=(4, 3)).astype(np.float32)
    normal = rng.normal(size=(4, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    kinds = [("matte", {}), ("mirror", {"kr": 0.7}),
             ("plastic", {}), ("emissive", {})]
    jm = JMaterials.concatenate([getattr(JMaterials, k)(**kw)
                                 for k, kw in kinds])
    tm = Materials.concatenate([getattr(Materials, k)(device=CPU, **kw)
                                for k, kw in kinds])
    jd, jkr = jm.specular_bounce(jnp.asarray(view), jnp.asarray(normal))
    td, tkr = tm.specular_bounce(torch.from_numpy(view),
                                 torch.from_numpy(normal))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(tkr.numpy(), np.asarray(jkr))
    np.testing.assert_array_equal(tkr.numpy(),
                                  np.float32([0.0, 0.7, 0.1, 0.1]))


def _assert_same_tree(j, t, path):
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(t):
            _assert_same_tree(getattr(j, f.name), getattr(t, f.name),
                              f"{path}.{f.name}")
        return
    if j is None or isinstance(j, (bool, int, float)):
        assert j == t, path
        return
    a = np.asarray(j)
    b = t.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, path
    if path.endswith("normals"):   # derived: rsqrt rounding
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=path)
    else:
        np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.mark.parametrize("name", ["tri_sphere_plane", "cornell_box"])
def test_basic_scenes_match_jax(name):
    js, jcam = getattr(jbasic, name)()
    ts, tcam = getattr(tbasic, name)(device=CPU)
    _assert_same_tree(js, ts, name)
    _assert_same_tree(jcam, tcam, name + ".cam")


def test_random_triangles_match_jax():
    for a, b in zip(jbasic.random_triangles(50, seed=3),
                    tbasic.random_triangles(50, seed=3)):
        np.testing.assert_array_equal(a, b)
