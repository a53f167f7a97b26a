"""``render``, the path tracer and the training step on an LBVH scene (the
CLI's default tree), the port against the JAX package on the CPU.

Each package builds its own ``sponza_like_scene`` with its default LBVH
(tests/test_torch_lbvh.py holds the two trees equal):

- ``render(scene, cam, 32, 32)`` with defaults only (the simple kernel)
  and ``algo="whitted"``: test_torch_simple.py's image tolerance (mean abs
  <= 1e-4, at most 2% of pixels off by more than 1e-3), depths to rtol
  1e-5;
- the 3-bounce NEE path-traced frame (``render_pixels``, jittered_blend,
  frame 1) at 32x32: test_torch_pathtracing.py's image tolerance; on an
  LBVH every bounce traces unbinned, as in JAX;
- ``step.loss_and_grads`` against ``jax.value_and_grad`` of bench.py's
  loss at 16x16 in 160-lane tiles (test_torch_grad.py's configuration on
  the LBVH): loss rtol 1e-5, gradients relative L2 <= 1e-3, cosine >=
  0.999;
- a checkpointed bounce replays its traversal tape: the backward runs no
  search (a spy on the plain version, which the wrapper runs on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.sched import render as jrender

from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import lbvh as tl
from visionaray_torch.ops import traversal as tt
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender
from visionaray_torch.sched import step

from test_torch_grad import KW, TILE, _cosine, _rel_l2, _swizzle

torch.set_num_threads(1)
CPU = "cpu"


def _image_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


@pytest.fixture(scope="module")
def scenes():
    js, jcam = j_sponza(target_tris=2000)
    ts, tcam = sponza_like_scene(target_tris=2000, device=CPU)
    assert isinstance(ts.bvh, tl.BVH)
    return js, jcam, ts, tcam


class _Spy:
    """Counts calls of the plain search while ``on``."""

    def __init__(self, fn):
        self.fn = fn
        self.on = True
        self.calls = []

    def __call__(self, *a, **k):
        if self.on:
            self.calls.append(a[6])    # the mode
        return self.fn(*a, **k)


@pytest.mark.parametrize("algo,modes", [("simple", ["closest"]),
                                        ("whitted", None)])
def test_render_matches_jax(scenes, algo, modes, monkeypatch):
    js, jcam, ts, tcam = scenes
    W = H = 32
    spy = _Spy(tt.traverse_bvh_plain)
    monkeypatch.setattr(tt, "traverse_bvh_plain", spy)
    kw = {} if algo == "simple" else dict(algo=algo)
    jrt = jrender.render(js, jcam, W, H, **kw)
    trt = trender.render(ts, tcam, W, H, **kw)
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5)
    assert float((trt.depth > 0).float().mean()) > 0.5
    if modes is not None:
        assert spy.calls == modes
    else:
        assert set(spy.calls) == {"closest", "any"}


def test_nee_frame_matches_jax(scenes, monkeypatch):
    js, jcam, ts, tcam = scenes
    W = H = 32
    kw = dict(num_bounces=3, epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
              ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = jrender._pixel_grid(W, H)
    jcol, jdepth = jrender.render_pixels(
        JParams.create(js, **kw), jcam, x, y, W, H, "pathtracing", 1,
        "jittered_blend", jnp.uint32(1), nee=True)
    spy = _Spy(tt.traverse_bvh_plain)
    monkeypatch.setattr(tt, "traverse_bvh_plain", spy)
    tx, ty = trender._pixel_grid(W, H, CPU)
    col, depth = trender.render_pixels(
        KernelParams.create(ts, **kw), tcam, tx, ty, W, H, "pathtracing", 1,
        "jittered_blend", 1, nee=True)
    assert spy.calls == ["closest", "any"] * 3
    _image_close(col.numpy(), jcol)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5)
    assert float(col[:, :3].std()) > 0


def _jax_step(js, jcam, x, y):
    p = JParams.create(js, **KW)
    W = H = 16
    n = x.shape[0]
    n_tiles = -(-n // TILE)
    pad = n_tiles * TILE - n
    xt = jnp.asarray(np.concatenate([x, np.zeros(pad, np.int32)])
                     ).reshape(n_tiles, TILE)
    yt = jnp.asarray(np.concatenate([y, np.zeros(pad, np.int32)])
                     ).reshape(n_tiles, TILE)

    def loss_fn(verts, cd):
        mesh2 = dataclasses.replace(p.scene.mesh, vertices=verts)
        mats2 = dataclasses.replace(p.scene.materials, cd=cd)
        p2 = dataclasses.replace(p, scene=dataclasses.replace(
            p.scene, mesh=mesh2, materials=mats2))

        def tile_fn(args):
            tx, ty = args
            color, _ = jrender.render_pixels(p2, jcam, tx, ty, W, H,
                                             "pathtracing", 1,
                                             "jittered_blend",
                                             jnp.uint32(1), nee=True)
            return jnp.sum(color[..., :3])

        return jnp.sum(jax.lax.map(tile_fn, (xt, yt))) / (n * 3)

    loss, (gv, gc) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        js.mesh.vertices, js.materials.cd)
    return float(loss), np.asarray(gv), np.asarray(gc)


def test_loss_and_grads_match_jax(scenes, monkeypatch):
    js, jcam, ts, tcam = scenes
    x, y = _swizzle(16, 16, 8)
    jloss, jgv, jgc = _jax_step(js, jcam, x, y)
    params = KernelParams.create(ts, **KW)
    verts = params.scene.mesh.vertices.clone().requires_grad_()
    cd = params.scene.materials.cd.clone().requires_grad_()
    spy = _Spy(tt.traverse_bvh_plain)
    monkeypatch.setattr(tt, "traverse_bvh_plain", spy)
    loss = step.frame_loss(verts, cd, 1, params, tcam, torch.as_tensor(x),
                           torch.as_tensor(y), nee=True, width=16,
                           height=16, tile=TILE)
    forward = list(spy.calls)
    spy.calls.clear()
    gv, gc = torch.autograd.grad(loss, (verts, cd))
    # two tiles, 3 bounces, a closest and an any-hit search each; the
    # checkpointed bounces replay their tapes: no search in backward
    assert forward == ["closest", "any"] * 6
    assert spy.calls == []
    gv, gc = gv.numpy(), gc.numpy()
    assert np.isfinite(gv).all() and np.abs(gv).sum() > 0
    assert np.isfinite(gc).all() and np.abs(gc).sum() > 0
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    for got, ref in ((gc, jgc), (gv, jgv)):
        assert _rel_l2(got, ref) <= 1e-3, _rel_l2(got, ref)
        assert _cosine(got, ref) >= 0.999, _cosine(got, ref)
    # loss_and_grads gives the same numbers
    loss2, (gv2, gc2) = step.loss_and_grads(
        params.scene.mesh.vertices, params.scene.materials.cd, 1, params,
        tcam, torch.as_tensor(x), torch.as_tensor(y), nee=True, width=16,
        height=16, tile=TILE)
    assert float(loss2) == float(loss.detach())
    np.testing.assert_array_equal(gv2.numpy(), gv)
