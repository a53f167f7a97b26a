"""The port's training step vs the JAX package on the CPU.

(a) ``_HitTuv``'s backward against ``jax.vjp`` of ``_hit_tuv`` on the
    48-triangle fixture of test_pallas_traverse.py: rtol 1e-4 / atol 1e-6,
    in f64 for ori, dir and the corner table (measured max abs difference
    3.6e-14) and in f32 for ori and dir (see the test for why not tbl).
(b) ``sched/step.py::loss_and_grads`` against ``jax.value_and_grad`` of
    bench.py's loss_fn body on sponza_like(4000) (4,804 triangles), K=8,
    T=16, 16x16 pixels in a block swizzle, 3 bounces, NEE, frame 1, in
    tiles of 160 lanes (so the last tile carries 64 padding lanes at pixel
    (0, 0), as bench.py's does at 1080p).  JAX runs the Pallas kernel in
    interpret mode, as render_pixels picks on the CPU.  Tolerance: loss
    rtol 1e-5; relative L2 error of g_cd and g_verts <= 1e-3, cosine >=
    0.999.  Measured: loss rel 7.5e-8; g_cd rel L2 1.9e-7, g_verts rel L2
    9.8e-6; both cosines 1 to f32 rounding.
(c) A spy on ``cluster_traverse`` sees the forward's launches and none
    during backward(), on a treelet build and on a radix tree.
(d) test_gradients_via_recompute on a radix tree (K=16, C=3): vertex
    gradients of sum(t over hits) finite, non-zero and equal to JAX's to
    1e-4.  Measured: max abs difference 1.9e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.ops.trace import intersect_triangles_brute as jbrute
from visionaray_tpu.scenes import random_triangles
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.sched.render import render_pixels as j_render_pixels

from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import step

torch.set_num_threads(1)
CPU = "cpu"
W = H = 16
TILE = 160
KW = dict(num_bounces=3, epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
          ambient_color=(1.0, 1.0, 1.0, 1.0))


def _fixture48():
    """test_pallas_traverse.py's triangles and rays (24 aimed at
    centroids, 8 far off to the side)."""
    verts, faces = random_triangles(48, seed=5, extent=3.0, tri_size=1.0)
    rng = np.random.default_rng(1)
    cent = verts.reshape(-1, 3, 3).mean(axis=1)
    targets = cent[rng.integers(0, len(cent), 24)]
    o = np.stack([rng.uniform(-1, 1, 32), rng.uniform(-1, 1, 32),
                  np.full(32, -9.0)], -1).astype(np.float32)
    d = np.zeros_like(o)
    d[:24] = targets - o[:24]
    d[24:] = [0.0, 0.0, 1.0]
    d[24:, :2] += rng.uniform(5, 9, (8, 2))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return verts, faces, o, d


def _swizzle(width, height, block):
    """bench.py's pixel-block order at another block size."""
    Wp, Hp = -(-width // block) * block, -(-height // block) * block
    yy, xx = np.meshgrid(np.arange(Hp), np.arange(Wp), indexing="ij")
    inb = (xx < width) & (yy < height)
    order = (yy // block) * (Wp // block) + (xx // block)
    flat = np.argsort(np.where(inb, order, 1 << 30).reshape(-1),
                      kind="stable")[: width * height]
    return (xx.reshape(-1)[flat].astype(np.int32),
            yy.reshape(-1)[flat].astype(np.int32))


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _cosine(got, ref):
    return float((got * ref).sum()
                 / (np.linalg.norm(got) * np.linalg.norm(ref)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hit_tuv_backward_matches_jax_vjp(dtype):
    verts, faces, o, d = _fixture48()
    jm = JMesh.create(verts, faces)
    v1, e1, e2 = jm.corners()
    tbl = np.asarray(jnp.concatenate(
        [v1, e1, e2, jnp.zeros(v1.shape[:-1] + (7,))], axis=-1))
    ref = jbrute(JRay(jnp.asarray(o), jnp.asarray(d)), v1, e1, e2,
                 jm.geom_ids)
    hit = np.asarray(ref.hit)
    assert hit.sum() >= 20
    pid = np.where(hit, np.asarray(ref.prim_id), 0).astype(np.int32)
    rng = np.random.default_rng(2)
    cts = [rng.normal(size=32) * hit for _ in range(3)]
    ins = [np.asarray(a, dtype) for a in (o, d, tbl)]
    ktuv = [np.asarray(a, dtype) for a in (ref.t, ref.u, ref.v)]
    cts = [c.astype(dtype) for c in cts]

    with jax.enable_x64(dtype == "float64"):
        _, vjp = jax.vjp(lambda a, b, c: jtrav._hit_tuv(
            a, b, c, jnp.asarray(pid), *map(jnp.asarray, ktuv)),
            *map(jnp.asarray, ins))
        jgrads = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cts)))]

    args = [torch.tensor(a, requires_grad=True) for a in ins]
    outs = trav._HitTuv.apply(*args, torch.as_tensor(pid),
                              *map(torch.tensor, ktuv))
    for a, b in zip(outs, ktuv):   # forward: the values as given
        np.testing.assert_array_equal(a.detach().numpy(), b)
    tgrads = torch.autograd.grad(outs, args, list(map(torch.tensor, cts)))
    # In f32 the corner-table gradient of rays aimed at centroids is
    # ill-conditioned: against the f64 value XLA's f32 result is off by up
    # to 2.3e-3 (7 of 768 entries beyond rtol 1e-4) and the port's by
    # 3.5e-4 (1 entry), so f32 compares the ray gradients only.
    names = ("ori", "dir", "tbl") if dtype == "float64" else ("ori", "dir")
    for name, g, jg in zip(names, tgrads, jgrads):
        assert np.abs(jg).sum() > 0, name
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _jax_step(x, y):
    js, jcam = j_sponza(target_tris=4000, build_bvh=False)
    js = dataclasses.replace(js, bvh=jax.jit(
        jbuild, static_argnames=("cluster_size", "treelet_size"))(
            js.mesh, cluster_size=8, treelet_size=16))
    p = JParams.create(js, **KW)
    n = x.shape[0]
    n_tiles = -(-n // TILE)
    pad = n_tiles * TILE - n
    xt = jnp.asarray(np.concatenate([x, np.zeros(pad, np.int32)])
                     ).reshape(n_tiles, TILE)
    yt = jnp.asarray(np.concatenate([y, np.zeros(pad, np.int32)])
                     ).reshape(n_tiles, TILE)

    def loss_fn(verts, cd):   # bench.py:123-137 at this size
        mesh2 = dataclasses.replace(p.scene.mesh, vertices=verts)
        mats2 = dataclasses.replace(p.scene.materials, cd=cd)
        p2 = dataclasses.replace(p, scene=dataclasses.replace(
            p.scene, mesh=mesh2, materials=mats2))

        def tile_fn(args):
            tx, ty = args
            color, _ = j_render_pixels(p2, jcam, tx, ty, W, H,
                                       "pathtracing", 1, "jittered_blend",
                                       jnp.uint32(1), nee=True)
            return jnp.sum(color[..., :3])

        return jnp.sum(jax.lax.map(tile_fn, (xt, yt))) / (n * 3)

    loss, (gv, gc) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        js.mesh.vertices, js.materials.cd)
    return float(loss), np.asarray(gv), np.asarray(gc)


def _port_scene(treelet_size=16):
    ts, tcam = sponza_like_scene(target_tris=4000, build_bvh=False,
                                 device=CPU)
    ts.bvh = build_cluster_bvh(ts.mesh, cluster_size=8,
                               treelet_size=treelet_size)
    return KernelParams.create(ts, **KW), tcam


def test_loss_and_grads_match_jax_value_and_grad():
    x, y = _swizzle(W, H, 8)
    jloss, jgv, jgc = _jax_step(x, y)
    params, cam = _port_scene()
    assert (params.scene.bvh.num_clusters,
            params.scene.bvh.num_treelets) == (1024, 64)
    loss, (gv, gc) = step.loss_and_grads(
        params.scene.mesh.vertices, params.scene.materials.cd, 1, params,
        cam, torch.as_tensor(x), torch.as_tensor(y), nee=True, width=W,
        height=H, tile=TILE)
    gv, gc = gv.numpy(), gc.numpy()
    assert np.isfinite(gv).all() and np.isfinite(gc).all()
    assert np.abs(gv).sum() > 0 and np.abs(gc).sum() > 0
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for got, ref in ((gc, jgc), (gv, jgv)):
        assert _rel_l2(got, ref) <= 1e-3, _rel_l2(got, ref)
        assert _cosine(got, ref) >= 0.999, _cosine(got, ref)


class _Spy:
    """Counts cluster_traverse calls while ``on``."""

    def __init__(self, fn):
        self.fn = fn
        self.on = False
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += self.on
        return self.fn(*a, **k)


@pytest.mark.parametrize("treelet_size", [16, 0], ids=["treelet", "radix"])
def test_backward_launches_no_traversal(treelet_size, monkeypatch):
    params, cam = _port_scene(treelet_size)
    assert params.scene.bvh.heap == (treelet_size > 0)
    spy = _Spy(trav.cluster_traverse)
    monkeypatch.setattr(trav, "cluster_traverse", spy)
    x, y = _swizzle(8, 8, 8)
    verts = params.scene.mesh.vertices.clone().requires_grad_()
    cd = params.scene.materials.cd.clone().requires_grad_()
    spy.on = True
    loss = step.frame_loss(verts, cd, 1, params, cam, torch.as_tensor(x),
                           torch.as_tensor(y), nee=True, width=8, height=8,
                           tile=64)
    forward_calls, spy.calls = spy.calls, 0
    gv, gc = torch.autograd.grad(loss, (verts, cd))
    assert forward_calls >= 2 * params.num_bounces - 1
    assert spy.calls == 0, "backward() re-ran a traversal"
    assert torch.isfinite(gv).all() and float(gv.abs().sum()) > 0
    assert torch.isfinite(gc).all() and float(gc.abs().sum()) > 0


def test_radix_gradients_via_recompute_match_jax():
    verts, faces, o, d = _fixture48()
    jm = JMesh.create(verts, faces)
    jb = jbuild(jm, cluster_size=16)
    assert (jb.num_clusters, jb.heap) == (3, False)

    def jloss(v):
        m2 = dataclasses.replace(jm, vertices=v)
        hr = jtrav.cluster_closest_hit(JRay(jnp.asarray(o), jnp.asarray(d)),
                                       jb, m2, interpret=True)
        return jnp.sum(jnp.where(hr.hit, hr.t, 0.0))

    jg = np.asarray(jax.grad(jloss)(jm.vertices))

    tm = TriangleMesh.create(verts, faces, device=CPU)
    tb = build_cluster_bvh(tm, cluster_size=16)
    assert (tb.num_clusters, tb.heap, tb.depth) == (3, False, 2)
    v = tm.vertices.clone().requires_grad_()
    hr = trav.cluster_closest_hit(Ray(torch.as_tensor(o), torch.as_tensor(d)),
                                  tb, dataclasses.replace(tm, vertices=v))
    (g,) = torch.autograd.grad(torch.where(hr.hit, hr.t, 0.0).sum(), v)
    g = g.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-4)
