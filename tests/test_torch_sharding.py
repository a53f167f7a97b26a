"""Tile sharding (parallel/tile_sharding.py) against the JAX package's
``render_image_sharded`` on ``make_mesh(2)`` and ``make_mesh(4)``, the
port on 2 and 4 gloo ranks (tests/test_sharding.py's cases, through
tests/test_torch_multihost.py's harness; both packages build the same
scenes from their own ``scenes/basic.py``):

- the simple frame of ``tri_sphere_plane`` at 32 x 32 and its path-traced
  frame at 16 x 16 (2 bounces, jittered_blend): the port's frame at the
  image tolerance of tests/test_torch_simple.py (mean abs <= 1e-4, at
  most 2% of pixels off by more than 1e-3) against JAX's at the same
  mesh size; the RNG is keyed by pixel id, so the port's frames at 2 and
  4 ranks also equal the single-process ``render_pixels`` frame;
- examples/inverse_rendering.py's gradient: the Cornell box at 16 x 16,
  2 bounces, the MSE against the true albedos' frame, with respect to
  ``cd`` and ``ls``: each rank's share, summed by ``all_reduce_grads``,
  within relative L2 1e-3 (cosine >= 0.999) of ``jax.grad`` through
  JAX's ``shard_map``, and the loss within rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.parallel import tile_sharding as jts
from visionaray_tpu.scenes import cornell_box, tri_sphere_plane

from test_torch_multihost import run_ranks
from visionaray_torch.parallel import tile_sharding as tts

torch.set_num_threads(1)
INV = 16       # the inverse-rendering frame's width and height
INV_BOUNCES = 2


def image_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


def _jax_frames(D):
    mesh = jts.make_mesh(D)
    scene, cam = tri_sphere_plane()
    p1 = JParams.create(scene, num_bounces=2, bg_color=(0.1, 0.4, 1.0, 1.0))
    simple, _ = jax.jit(lambda p: jts.render_image_sharded(
        p, cam, 32, 32, mesh, algo="simple", spp=1,
        pixel_sampler="uniform", frame_num=1))(p1)
    p2 = JParams.create(scene, num_bounces=2, bg_color=(0, 0, 0, 1),
                        ambient_color=(1, 1, 1, 1))
    pt, _ = jax.jit(lambda p: jts.render_image_sharded(
        p, cam, 16, 16, mesh, algo="pathtracing", spp=1,
        pixel_sampler="jittered_blend", frame_num=1))(p2)
    return np.asarray(simple), np.asarray(pt)


def _jax_inverse(D):
    """examples/inverse_rendering.py's loss and gradient at the start."""
    mesh = jts.make_mesh(D)
    scene, cam = cornell_box()
    base = JParams.create(scene, num_bounces=INV_BOUNCES, epsilon=1e-3,
                          bg_color=(0, 0, 0, 1), ambient_color=(0, 0, 0, 0))

    def render_theta(theta, frame):
        mats = dataclasses.replace(base.scene.materials, cd=theta["cd"],
                                   ls=theta["ls"])
        p2 = dataclasses.replace(
            base, scene=dataclasses.replace(base.scene, materials=mats))
        color, _ = jts.render_image_sharded(
            p2, cam, INV, INV, mesh, algo="pathtracing", spp=1,
            pixel_sampler="jittered_blend", frame_num=frame)
        return color[..., :3]

    true = {"cd": scene.materials.cd, "ls": scene.materials.ls}
    target = jax.jit(render_theta)(true, jnp.uint32(9999))
    theta = {"cd": jnp.clip(scene.materials.cd * 0.3 + 0.3, 0.05, 0.95),
             "ls": scene.materials.ls * 0.5}
    loss, g = jax.jit(jax.value_and_grad(
        lambda th: jnp.mean((render_theta(th, jnp.uint32(1)) - target)
                            ** 2)))(theta)
    return float(loss), np.asarray(g["cd"]), np.asarray(g["ls"])


_BODY = """
import dataclasses
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.parallel.tile_sharding import (
    all_reduce_grads, make_mesh, render_image_sharded,
)
from visionaray_torch.scenes import cornell_box, tri_sphere_plane
from visionaray_torch.sched.render import _render_frame
mesh = make_mesh()
scene, cam = tri_sphere_plane(device="cpu")
p1 = KernelParams.create(scene, num_bounces=2, bg_color=(0.1, 0.4, 1.0, 1.0))
OUT["simple"] = render_image_sharded(
    p1, cam, 32, 32, mesh, algo="simple", spp=1, pixel_sampler="uniform",
    frame_num=1)[0].numpy()
p2 = KernelParams.create(scene, num_bounces=2, bg_color=(0, 0, 0, 1),
                         ambient_color=(1, 1, 1, 1))
OUT["pt"] = render_image_sharded(
    p2, cam, 16, 16, mesh, algo="pathtracing", spp=1,
    pixel_sampler="jittered_blend", frame_num=1)[0].numpy()
OUT["pt_single"] = _render_frame(p2, cam, 16, 16, "pathtracing", 1,
                                 "jittered_blend", 0, 1)[0].numpy()

scene, cam = cornell_box(device="cpu")
base = KernelParams.create(scene, num_bounces=2, epsilon=1e-3,
                           bg_color=(0, 0, 0, 1), ambient_color=(0, 0, 0, 0))


def render_theta(cd, ls, frame):
    mats = dataclasses.replace(scene.materials, cd=cd, ls=ls)
    p = dataclasses.replace(base, scene=dataclasses.replace(
        base.scene, materials=mats))
    return render_image_sharded(p, cam, 16, 16, mesh, algo="pathtracing",
                                spp=1, pixel_sampler="jittered_blend",
                                frame_num=frame)[0][..., :3]


with torch.no_grad():
    target = render_theta(scene.materials.cd, scene.materials.ls, 9999)
cd = torch.clip(scene.materials.cd * 0.3 + 0.3, 0.05, 0.95).requires_grad_()
ls = (scene.materials.ls * 0.5).requires_grad_()
loss = torch.mean((render_theta(cd, ls, 1) - target) ** 2)
loss.backward()
all_reduce_grads([cd, ls], mesh)
OUT["loss"] = loss.detach().numpy()
OUT["gcd"] = cd.grad.numpy()
OUT["gls"] = ls.grad.numpy()
"""


@pytest.fixture(scope="module", params=(2, 4), ids=lambda d: f"D{d}")
def runs(request, tmp_path_factory):
    D = request.param
    ref = dict(zip(("simple", "pt"), _jax_frames(D)))
    ref["loss"], ref["gcd"], ref["gls"] = _jax_inverse(D)
    outs = run_ranks(tmp_path_factory.mktemp(f"tile{D}"), D, _BODY, {})
    return D, ref, outs


@pytest.mark.parametrize("frame", ["simple", "pt"])
def test_tile_sharded_frame_matches_jax(runs, frame):
    D, ref, outs = runs
    for out in outs:   # every rank returns the whole frame
        image_close(out[frame], ref[frame])


def test_tile_sharded_pt_equals_single_process(runs):
    """RNG keyed by absolute pixel id: the sharded frame is the
    single-process frame (the same kernels on the same pixels)."""
    _, _, outs = runs
    for out in outs:
        np.testing.assert_allclose(out["pt"], out["pt_single"], rtol=1e-6,
                                   atol=1e-6)


def test_inverse_rendering_gradient_matches_jax(runs):
    D, ref, outs = runs
    for out in outs:
        np.testing.assert_allclose(float(out["loss"]), ref["loss"],
                                   rtol=1e-5)
        for k in ("gcd", "gls"):
            a, b = out[k].astype(np.float64), ref[k].astype(np.float64)
            assert np.isfinite(a).all() and np.abs(b).max() > 0
            assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-3
            assert a.reshape(-1) @ b.reshape(-1) >= 0.999 * (
                np.linalg.norm(a) * np.linalg.norm(b))


def test_pad_to_multiple_matches_jax():
    x = np.arange(10, dtype=np.int32)
    for m in (1, 3, 4, 10, 16):
        np.testing.assert_array_equal(
            tts.pad_to_multiple(torch.as_tensor(x), m).numpy(),
            np.asarray(jts.pad_to_multiple(jnp.asarray(x), m)))


def test_make_mesh_single_process():
    mesh = tts.make_mesh()
    assert mesh.size == 1 and mesh.axis_names == (tts.TILE_AXIS,)
    assert tts.make_mesh(1).size == 1
    with pytest.raises(ValueError, match="all ranks or one"):
        tts.make_mesh(3)
