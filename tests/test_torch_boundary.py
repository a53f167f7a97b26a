"""The port's boundary gradients (diff/boundary.py) against the JAX package
on the CPU, on the pattern of tests/test_boundary_gradients.py.

- ``build_edge_adjacency`` and ``silhouette_mask`` equal to JAX's, on the
  welded Cornell box and on a triangle.
- ``boundary_image``'s vertex gradient against JAX's (``edge_budget=None``)
  on the triangle and on the point-lit Cornell box, at rtol 1e-4 of the
  gradient's largest entry; its value exactly 0.
- The triangle's translation gradient (render + boundary term) against
  central finite differences of a 64-spp jittered render, at JAX's test's
  12%.
- ``shadow_boundary_image`` (blocker, receiver and light) and
  ``sphere_boundary_image`` (centre and radius) against JAX's gradients at
  rtol 1e-4 of the largest entry; values exactly 0.
- ``render(boundary=...)`` on a triangle scene and on a sphere scene: the
  gradient of a loss over the frame against ``jax.grad`` of the same, at
  rtol 1e-4 of the largest entry.
- ``edge_budget``: the port draws edges with a torch.Generator, JAX with
  ``jax.random.categorical``, so the two agree in expectation only: the
  mean of 24 seeds' budget gradients matches the full gradient within 4
  standard errors plus 5%, as test_edge_budget_is_consistent holds JAX.
- A MatrixCamera's boundary gradient equals the Pinhole's within 2e-3
  relative, as in JAX's test.

Scenes at 48x48 or 32x32, the simple kernel (Whitted for the shadow term),
tens of triangles, brute-force traversal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.camera import Pinhole as JPinhole
from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.core.scene import Spheres as JSpheres
from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.diff import boundary as jb
from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.scenes import cornell_box as j_cornell
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading.lights import PointLights as JPointLights
from visionaray_tpu.shading.materials import Materials as JMaterials

from visionaray_torch import convert
from visionaray_torch.core.camera import MatrixCamera, Pinhole
from visionaray_torch.core.scene import Scene, Spheres, TriangleMesh
from visionaray_torch.diff import boundary as tb
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.scenes.basic import cornell_box
from visionaray_torch.sched import render as trender
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials

torch.set_num_threads(1)
CPU = "cpu"
W = H = 48
BG = (0.05, 0.10, 0.30, 1.0)
AMB = (0.2, 0.2, 0.2, 1.0)
WGT = np.linspace(0.5, 1.5, W, dtype=np.float32)[None, :, None]


def _jloss(c):
    return jnp.mean(c[..., :3] * WGT)


def _tloss(c):
    return torch.mean(c[..., :3] * torch.from_numpy(WGT))


def _close_grad(g, g_ref, rtol=1e-4):
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    assert np.isfinite(g).all() and np.abs(g_ref).max() > 0
    np.testing.assert_allclose(g, g_ref, rtol=rtol,
                               atol=rtol * np.abs(g_ref).max())


TRI_V = np.array([[-0.6, -0.5, 0.0], [0.7, -0.4, 0.0], [0.0, 0.8, 0.0]],
                 np.float32)
TRI_F = np.array([[0, 1, 2]], np.int32)
CAM = dict(eye=(0, 0, 3), center=(0, 0, 0), fovy=np.deg2rad(45),
           aspect=1.0)
J_CAM = JPinhole.create(**CAM)
T_CAM = Pinhole.create(device=CPU, **CAM)
LIGHT = [[2, 3, 4]]


def _jparams(verts, faces=TRI_F, mats=None, gids=None, lights=None):
    scene = JScene.create(
        mesh=JMesh.create(verts, faces, geom_ids=gids),
        materials=mats or JMaterials.matte(cd=(0.8, 0.3, 0.2)),
        lights=lights or JPointLights.create(position=LIGHT))
    return JParams.create(scene, num_bounces=1, epsilon=1e-3, bg_color=BG,
                          ambient_color=AMB)


def _tparams(verts, faces=TRI_F, mats=None, gids=None, lights=None):
    scene = Scene.create(
        mesh=TriangleMesh.create(verts, faces, geom_ids=gids, device=CPU),
        materials=mats or Materials.matte(cd=(0.8, 0.3, 0.2), device=CPU),
        lights=lights or PointLights.create(position=LIGHT, device=CPU),
        device=CPU)
    return KernelParams.create(scene, num_bounces=1, epsilon=1e-3,
                               bg_color=BG, ambient_color=AMB)


def _adj_pair(faces, verts=None):
    return (jb.build_edge_adjacency(faces, verts),
            tb.build_edge_adjacency(faces, verts, device=CPU))


def _cornell_pointlit():
    s = 5.55
    light = dict(position=[[0.5 * s, 0.9 * s, -1.0 * s]], cl=[[1.0, 1.0, 1.0]],
                 kl=[3.0])
    js, jcam = j_cornell()
    js = dataclasses.replace(js, lights=JPointLights.create(**light))
    ts, tcam = cornell_box(device=CPU)
    ts = dataclasses.replace(ts, lights=PointLights.create(device=CPU,
                                                           **light))
    return js, jcam, ts, tcam


# ------------------------------------------------------------ adjacency


@pytest.mark.parametrize("weld", [False, True])
def test_adjacency_and_silhouette_match_jax(weld):
    js, jcam, ts, tcam = _cornell_pointlit()
    faces = np.asarray(js.mesh.faces)
    verts = np.asarray(js.mesh.vertices)
    ja, ta = _adj_pair(faces, verts if weld else None)
    np.testing.assert_array_equal(ta.edges.numpy(), np.asarray(ja.edges))
    np.testing.assert_array_equal(ta.faces.numpy(), np.asarray(ja.faces))
    jm = jb.silhouette_mask(js.mesh.vertices, js.mesh.faces, ja, jcam.eye,
                            geom_ids=js.mesh.geom_ids)
    tm = tb.silhouette_mask(ts.mesh.vertices, ts.mesh.faces, ta, tcam.eye,
                            geom_ids=ts.mesh.geom_ids)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < tm.sum() < tm.numel()
    # carried across by convert.py, the same tensors
    tc = convert.edge_adjacency_from_arrays(
        {"edges": np.asarray(ja.edges), "faces": np.asarray(ja.faces)},
        device=CPU)
    assert torch.equal(tc.edges, ta.edges) and torch.equal(tc.faces,
                                                           ta.faces)


# -------------------------------------------------------- boundary term


def test_triangle_boundary_gradient_matches_jax():
    ja, ta = _adj_pair(TRI_F)

    def jf(v):
        return _jloss(jb.boundary_image(_jparams(v), J_CAM, W, H, ja,
                                        vertices=v, samples_per_edge=32))

    g_ref = jax.grad(jf)(jnp.asarray(TRI_V))
    v = torch.tensor(TRI_V, requires_grad=True)
    img = tb.boundary_image(_tparams(v), T_CAM, W, H, ta, vertices=v,
                            samples_per_edge=32)
    assert float(img.detach().abs().max()) == 0.0
    (g,) = torch.autograd.grad(_tloss(img), v)
    _close_grad(g.numpy(), g_ref)


def test_cornell_boundary_gradient_matches_jax():
    js, jcam, ts, tcam = _cornell_pointlit()
    ja, ta = _adj_pair(np.asarray(js.mesh.faces),
                       np.asarray(js.mesh.vertices))

    def jf(v):
        mesh = dataclasses.replace(js.mesh, vertices=v)
        p = JParams.create(dataclasses.replace(js, mesh=mesh),
                           num_bounces=1, epsilon=1e-3, bg_color=BG,
                           ambient_color=AMB)
        return _jloss(jb.boundary_image(p, jcam, W, H, ja, vertices=v,
                                        samples_per_edge=8))

    g_ref = jax.grad(jf)(js.mesh.vertices)
    v = ts.mesh.vertices.clone().requires_grad_()
    p = KernelParams.create(
        dataclasses.replace(ts, mesh=dataclasses.replace(ts.mesh,
                                                         vertices=v)),
        num_bounces=1, epsilon=1e-3, bg_color=BG, ambient_color=AMB)
    img = tb.boundary_image(p, tcam, W, H, ta, vertices=v,
                            samples_per_edge=8)
    (g,) = torch.autograd.grad(_tloss(img), v)
    _close_grad(g.numpy(), g_ref)


def _tri_render_loss(t, adj, spp=1, sampler="uniform", boundary=True):
    v = torch.from_numpy(TRI_V) + torch.stack(
        [t, torch.zeros_like(t), torch.zeros_like(t)])
    p = _tparams(v)
    color, _ = trender._render_frame(p, T_CAM, W, H, "simple", spp, sampler,
                                     0, 1, 0)
    if boundary:
        color = color + tb.boundary_image(p, T_CAM, W, H, adj, vertices=v,
                                          samples_per_edge=32)
    return _tloss(color)


def test_translation_gradient_matches_fd():
    _, ta = _adj_pair(TRI_F)
    h = 0.03
    with torch.no_grad():
        fd = (float(_tri_render_loss(torch.tensor(h), ta, 64, "jittered",
                                     False))
              - float(_tri_render_loss(torch.tensor(-h), ta, 64, "jittered",
                                       False))) / (2 * h)
    t = torch.tensor(0.0, requires_grad=True)
    (g,) = torch.autograd.grad(_tri_render_loss(t, ta), t)
    t2 = torch.tensor(0.0, requires_grad=True)
    (g_int,) = torch.autograd.grad(_tri_render_loss(t2, ta, boundary=False),
                                   t2)
    assert fd != 0.0
    assert abs(float(g) - fd) <= 0.12 * abs(fd), (float(g), fd)
    # fixed-topology autodiff alone sees nothing of the translation
    assert abs(float(g_int)) < 1e-6


# ------------------------------------------------------- shadow boundary

SHADOW_V = np.array([
    [-0.45, 0.8, -0.25], [0.45, 0.8, -0.2], [0.0, 0.8, 0.55],   # blocker
    [-2.5, 0.0, -2.5], [2.5, 0.0, -2.5], [2.5, 0.0, 2.5],
    [-2.5, 0.0, 2.5],                                           # ground
], np.float32)
SHADOW_F = np.array([[0, 1, 2], [3, 4, 5], [3, 5, 6]], np.int32)
SHADOW_G = np.array([0, 1, 1], np.int32)
SHADOW_CAM = dict(eye=(0.0, 2.6, 3.2), center=(0.0, 0.3, 0.0),
                  fovy=np.deg2rad(50), aspect=1.0)
SHADOW_L = dict(position=[[0.6, 3.0, 0.8], [-1.2, 2.6, 1.4]],
                cl=[[1.0, 0.9, 0.8], [0.6, 0.7, 1.0]], kl=[0.9, 0.8])


@pytest.mark.parametrize("light_index", [0, None])
def test_shadow_boundary_gradient_matches_jax(light_index):
    """Gradients with respect to every vertex (blocker and receiver) and,
    for one light, its position."""
    ja, ta = _adj_pair(SHADOW_F, SHADOW_V)
    jmats = JMaterials.concatenate([JMaterials.matte(cd=(0.8, 0.3, 0.2)),
                                    JMaterials.matte(cd=(0.7, 0.7, 0.65))])
    tmats = Materials.concatenate([
        Materials.matte(cd=(0.8, 0.3, 0.2), device=CPU),
        Materials.matte(cd=(0.7, 0.7, 0.65), device=CPU)])
    jcam = JPinhole.create(**SHADOW_CAM)
    tcam = Pinhole.create(device=CPU, **SHADOW_CAM)
    L0 = np.float32(SHADOW_L["position"][0])
    one = light_index == 0

    def jf(v, L):
        p = _jparams(v, SHADOW_F, jmats, SHADOW_G,
                     JPointLights.create(**SHADOW_L))
        return _jloss(jb.shadow_boundary_image(
            p, jcam, W, H, ja, algo="whitted", vertices=v,
            samples_per_edge=8, light_index=light_index,
            light_pos=L if one else None))

    gv_ref, gl_ref = jax.grad(jf, argnums=(0, 1))(jnp.asarray(SHADOW_V),
                                                  jnp.asarray(L0))
    v = torch.tensor(SHADOW_V, requires_grad=True)
    L = torch.tensor(L0, requires_grad=True)
    p = _tparams(v, SHADOW_F, tmats, SHADOW_G,
                 PointLights.create(device=CPU, **SHADOW_L))
    img = tb.shadow_boundary_image(p, tcam, W, H, ta, algo="whitted",
                                   vertices=v, samples_per_edge=8,
                                   light_index=light_index,
                                   light_pos=L if one else None)
    assert float(img.detach().abs().max()) == 0.0
    gv, gl = torch.autograd.grad(_tloss(img), (v, L), allow_unused=True)
    _close_grad(gv.numpy(), gv_ref)
    assert np.abs(gv.numpy()[3:]).sum() > 0 and np.abs(gv.numpy()[:3]).sum()
    if one:
        _close_grad(gl.numpy(), gl_ref)


# ------------------------------------------------------ sphere boundary

C0 = np.array([0.1, -0.15, 0.0], np.float32)
R0 = np.float32(0.55)


def test_sphere_boundary_gradient_matches_jax():
    def jparams(c, r):
        scene = JScene.create(spheres=JSpheres.create(c[None, :], r[None]),
                              materials=JMaterials.matte(cd=(0.3, 0.7, 0.4)),
                              lights=JPointLights.create(position=LIGHT))
        return JParams.create(scene, num_bounces=1, epsilon=1e-3,
                              bg_color=BG, ambient_color=AMB)

    def jf(c, r):
        return _jloss(jb.sphere_boundary_image(
            jparams(c, r), J_CAM, W, H, centers=c[None, :], radii=r[None],
            samples_per_sphere=64))

    gc_ref, gr_ref = jax.grad(jf, argnums=(0, 1))(jnp.asarray(C0),
                                                  jnp.asarray(R0))
    c = torch.tensor(C0, requires_grad=True)
    r = torch.tensor(R0, requires_grad=True)
    scene = Scene.create(
        spheres=Spheres.create(c[None, :], r[None], device=CPU),
        materials=Materials.matte(cd=(0.3, 0.7, 0.4), device=CPU),
        lights=PointLights.create(position=LIGHT, device=CPU), device=CPU)
    p = KernelParams.create(scene, num_bounces=1, epsilon=1e-3, bg_color=BG,
                            ambient_color=AMB)
    img = tb.sphere_boundary_image(p, T_CAM, W, H, centers=c[None, :],
                                   radii=r[None], samples_per_sphere=64)
    assert float(img.detach().abs().max()) == 0.0
    gc, gr = torch.autograd.grad(_tloss(img), (c, r))
    _close_grad(gc.numpy(), gc_ref)
    _close_grad(gr.numpy(), gr_ref)


# ---------------------------------------------------- render(boundary=)


def test_render_boundary_on_triangles_matches_jax():
    ja, ta = _adj_pair(TRI_F)
    kw = dict(algo="simple", bg_color=BG, ambient=AMB, epsilon=1e-3)

    def jf(v):
        p = _jparams(v)
        return _jloss(jrender.render(p.scene, J_CAM, W, H, boundary=ja,
                                     **kw).color)

    g_ref = jax.grad(jf)(jnp.asarray(TRI_V))
    v = torch.tensor(TRI_V, requires_grad=True)
    rt = trender.render(_tparams(v).scene, T_CAM, W, H, boundary=ta, **kw)
    (g,) = torch.autograd.grad(_tloss(rt.color), v)
    _close_grad(g.numpy(), g_ref)
    # boundary=True builds the adjacency itself
    v2 = torch.tensor(TRI_V, requires_grad=True)
    rt2 = trender.render(_tparams(v2).scene, T_CAM, W, H, boundary=True,
                         boundary_opts={"samples_per_edge": 4}, **kw)
    (g2,) = torch.autograd.grad(_tloss(rt2.color), v2)
    assert np.isfinite(g2.numpy()).all() and np.abs(g2.numpy()).sum() > 0


def test_render_boundary_on_spheres_matches_jax():
    kw = dict(algo="simple", bg_color=BG, ambient=AMB, epsilon=1e-3)

    def jf(t):
        scene = JScene.create(
            spheres=JSpheres.create(jnp.asarray([[0.1, -0.15, 0.0]])
                                    + jnp.array([t, 0.0, 0.0]),
                                    jnp.asarray([0.55])),
            materials=JMaterials.matte(cd=(0.3, 0.7, 0.4)),
            lights=JPointLights.create(position=LIGHT))
        return _jloss(jrender.render(scene, J_CAM, W, H, boundary=True,
                                     **kw).color)

    g_ref = float(jax.grad(jf)(0.0))
    t = torch.tensor(0.0, requires_grad=True)
    centers = torch.tensor([[0.1, -0.15, 0.0]]) + torch.stack(
        [t, torch.zeros_like(t), torch.zeros_like(t)])
    scene = Scene.create(
        spheres=Spheres.create(centers, [0.55], device=CPU),
        materials=Materials.matte(cd=(0.3, 0.7, 0.4), device=CPU),
        lights=PointLights.create(position=LIGHT, device=CPU), device=CPU)
    rt = trender.render(scene, T_CAM, W, H, boundary=True, **kw)
    (g,) = torch.autograd.grad(_tloss(rt.color), t)
    assert g_ref != 0.0
    _close_grad(float(g), g_ref)


# ------------------------------------------------------ budget, camera


def _cornell_term(ts, tcam, ta, t, sel, **opts):
    v = ts.mesh.vertices + t * sel
    p = KernelParams.create(
        dataclasses.replace(ts, mesh=dataclasses.replace(ts.mesh,
                                                         vertices=v)),
        num_bounces=1, epsilon=1e-3, bg_color=BG, ambient_color=AMB)
    return _tloss(tb.boundary_image(p, tcam, W, H, ta, vertices=v,
                                    samples_per_edge=16, **opts))


def test_edge_budget_is_consistent():
    _, _, ts, tcam = _cornell_pointlit()
    ta = tb.build_edge_adjacency(ts.mesh.faces.numpy(),
                                 ts.mesh.vertices.numpy(), device=CPU)
    sel = torch.zeros_like(ts.mesh.vertices)
    sel[-24:, 0] = 1.0   # the tall box

    def grad(**opts):
        t = torch.tensor(0.0, requires_grad=True)
        return float(torch.autograd.grad(
            _cornell_term(ts, tcam, ta, t, sel, **opts), t)[0])

    g_full = grad()
    picks = [grad(edge_budget=24, seed=s) for s in range(24)]
    assert len(set(picks)) > 1       # a fresh draw per seed
    mean = float(np.mean(picks))
    sem = float(np.std(picks)) / np.sqrt(len(picks))
    assert g_full != 0.0
    assert abs(mean - g_full) <= 4.0 * sem + 0.05 * abs(g_full), (
        mean, sem, g_full)
    # the frame number folds into the draw
    assert grad(edge_budget=24, seed=0, frame_num=2) != picks[0]


def test_matrix_camera_boundary_matches_pinhole():
    _, ta = _adj_pair(TRI_F)

    def g(cam):
        t = torch.tensor(0.0, requires_grad=True)
        v = torch.from_numpy(TRI_V) + torch.stack(
            [t, torch.zeros_like(t), torch.zeros_like(t)])
        img = tb.boundary_image(_tparams(v), cam, W, H, ta, vertices=v,
                                samples_per_edge=16)
        return float(torch.autograd.grad(_tloss(img), t)[0])

    g_pin = g(T_CAM)
    g_mat = g(MatrixCamera.from_pinhole(T_CAM))
    assert g_pin != 0.0
    assert abs(g_mat - g_pin) <= 2e-3 * abs(g_pin) + 1e-7, (g_mat, g_pin)
