"""Gradients of the port's volume march against ``jax.grad`` of the JAX
package's ``volume_kernel``, on the CPU, where ``volume_march`` runs its
plain version (``kernels/volume.py::march_plain``) under autograd.

The loss is ``sum(color * w)`` with weights from a numpy seed over the
primary rays of the JAX camera (carried across as numpy), so both sides
march the same rays.  Texel, transfer and background gradients must agree
to relative L2 1e-5.  The gradients with respect to the rays and the
boxes (``o``, ``d``, ``lo``, ``hi``: through the sample positions, the
step ``dt`` and the slab entry) are taken of a loss that reads colour and
depth, ``sum(color * w) + sum(depth * wd)``, and must agree to relative L2
1e-4, all finite (measured 1.1e-6 to 5.3e-6: the sums run in another
order).

At an argument exactly on a bound, ``jnp.clip``'s gradient is 0.5 (its
``maximum``/``minimum`` split ties evenly); ``torch.clamp``'s is 1.  Both
demo transfer functions gate opacity to exactly 0 at low density, so
ties are common: the plain version clamps opacity with
``torch.minimum(torch.maximum(x, 0), 1)``, JAX's rule (ROADMAP F3; with
``torch.clamp`` the transfer gradient of ``volume_scene(12)`` is off by
relative L2 0.80).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.kernels import volume as jvol
from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.scenes import volume_demo as jdemo
from visionaray_tpu.sched.render import _pixel_grid as j_pixel_grid

from visionaray_torch.kernels import volume as tvol
from visionaray_torch.scenes import volume_demo as tdemo

torch.set_num_threads(1)
CPU = "cpu"
BG = (0.1, 0.4, 1.0, 1.0)
REL_L2 = 1e-5
PIXELS = 16   # 16 x 16 = 256 primary rays

SCENES = {"single": (lambda: jdemo.volume_scene(12),
                     lambda: tdemo.volume_scene(12, device=CPU)),
          "multi": (lambda: jdemo.multi_volume_scene(12, 3),
                    lambda: tdemo.multi_volume_scene(12, 3, device=CPU))}


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _rays(jcam):
    x, y = j_pixel_grid(PIXELS, PIXELS)
    ray = jcam.primary_rays(x, y, PIXELS, PIXELS, None)
    return np.asarray(ray.ori).copy(), np.asarray(ray.dir).copy()


def _jax_grads(jvols, o, d, w):
    def loss(texels, transfer, bg):
        vols = dataclasses.replace(jvols, texels=texels, transfer=transfer)
        params = JParams.create(JScene.create(volumes=vols), bg_color=BG)
        params = dataclasses.replace(params, bg_color=bg)
        rec = jvol.volume_kernel(params, JRay(ori=jnp.asarray(o),
                                              dir=jnp.asarray(d)))
        return jnp.sum(rec.color * w)

    g = jax.grad(loss, argnums=(0, 1, 2))(jvols.texels, jvols.transfer,
                                          jnp.asarray(BG, jnp.float32))
    return [np.asarray(x) for x in g]


def _torch_grads(tvols, o, d, w):
    texels = tvols.texels.clone().requires_grad_()
    transfer = tvols.transfer.clone().requires_grad_()
    bg = torch.tensor(BG, dtype=torch.float32, requires_grad=True)
    vols = dataclasses.replace(tvols, texels=texels, transfer=transfer)
    color, _, _ = tvol.volume_march(torch.as_tensor(o), torch.as_tensor(d),
                                    vols, bg)
    (color * torch.as_tensor(w)).sum().backward()
    return [x.grad.numpy() for x in (texels, transfer, bg)]


@pytest.fixture(scope="module", params=list(SCENES))
def grads(request):
    jmake, tmake = SCENES[request.param]
    (js, jcam), (ts, _) = jmake(), tmake()
    o, d = _rays(jcam)
    w = np.random.default_rng(3).uniform(
        -1.0, 1.0, (o.shape[0], 4)).astype(np.float32)
    return _jax_grads(js.volumes, o, d, w), _torch_grads(ts.volumes, o, d, w)


def test_transfer_gradient_matches_jax(grads):
    (_, jtr, _), (_, ttr, _) = grads
    assert np.abs(jtr).max() > 0
    assert rel_l2(ttr, jtr) <= REL_L2, rel_l2(ttr, jtr)


def test_texel_gradient_matches_jax(grads):
    (jtx, _, _), (ttx, _, _) = grads
    assert np.abs(jtx).max() > 0
    assert rel_l2(ttx, jtx) <= REL_L2, rel_l2(ttx, jtx)


def test_bg_gradient_matches_jax(grads):
    (_, _, jbg), (_, _, tbg) = grads
    np.testing.assert_allclose(tbg, jbg, rtol=REL_L2, atol=0)


def test_clip_tie_takes_half_the_gradient():
    """One ray along z through a 2^3 box of constant density 0.25 whose
    transfer alpha is 0 everywhere: every step's opacity argument is
    exactly 0, where the gradient with respect to the transfer alpha is
    half the unclamped one, as jnp.clip's."""
    texels = np.full((4, 4, 4), 0.25, np.float32)
    transfer = np.zeros((4, 4), np.float32)
    transfer[:, :3] = 0.5
    jv = jvol.Volumes.create([[-1, -1, -1]], [[1, 1, 1]], texels, transfer)
    tv = tvol.Volumes.create([[-1, -1, -1]], [[1, 1, 1]], texels, transfer,
                             device=CPU)
    o = np.array([[0.0, 0.0, -3.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    w = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    (_, jtr, _), (_, ttr, _) = _jax_grads(jv, o, d, w), \
        _torch_grads(tv, o, d, w)
    np.testing.assert_allclose(ttr, jtr, rtol=REL_L2, atol=0)
    # 4 steps (dt = 0.5, t = 2 .. 3.5), each with dL/da = c.r * w.r -
    # w.r * bg.r = 0.4 and da/dc.a = dt * D = 2 unclamped, split over the
    # taps at entries 0 and 1: 3.2 in all, and half of it at the tie
    np.testing.assert_allclose(jtr[0, 0, 3] + jtr[0, 1, 3], 1.6, rtol=1e-5)
    assert (jtr[0, 2:, 3] == 0).all()


REL_L2_RAYS = 1e-4


def _jax_ray_grads(jvols, o, d, w, wd):
    def loss(o, d, lo, hi):
        vols = dataclasses.replace(jvols, lo=lo, hi=hi)
        params = JParams.create(JScene.create(volumes=vols), bg_color=BG)
        rec = jvol.volume_kernel(params, JRay(ori=o, dir=d))
        return jnp.sum(rec.color * w) + jnp.sum(rec.depth * wd)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(o), jnp.asarray(d), jvols.lo, jvols.hi)
    return [np.asarray(x) for x in g]


def _torch_ray_grads(tvols, o, d, w, wd):
    leaves = [torch.as_tensor(o).clone().requires_grad_(),
              torch.as_tensor(d).clone().requires_grad_(),
              tvols.lo.clone().requires_grad_(),
              tvols.hi.clone().requires_grad_()]
    vols = dataclasses.replace(tvols, lo=leaves[2], hi=leaves[3])
    color, _, depth = tvol.volume_march(
        leaves[0], leaves[1], vols, torch.tensor(BG, dtype=torch.float32))
    ((color * torch.as_tensor(w)).sum()
     + (depth * torch.as_tensor(wd)).sum()).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.fixture(scope="module", params=list(SCENES))
def ray_grads(request):
    jmake, tmake = SCENES[request.param]
    (js, jcam), (ts, _) = jmake(), tmake()
    o, d = _rays(jcam)
    rng = np.random.default_rng(4)
    w = rng.uniform(-1.0, 1.0, (o.shape[0], 4)).astype(np.float32)
    wd = rng.uniform(-1.0, 1.0, o.shape[0]).astype(np.float32)
    return (_jax_ray_grads(js.volumes, o, d, w, wd),
            _torch_ray_grads(ts.volumes, o, d, w, wd))


@pytest.mark.parametrize("name", ["o", "d", "lo", "hi"])
def test_ray_and_box_gradients_match_jax(ray_grads, name):
    """Item 6c on the CPU: the plain version's gradients with respect to
    the rays and the boxes against jax.grad of the JAX volume kernel."""
    k = ["o", "d", "lo", "hi"].index(name)
    ref, got = ray_grads[0][k], ray_grads[1][k]
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert np.abs(ref).max() > 0
    assert rel_l2(got, ref) <= REL_L2_RAYS, rel_l2(got, ref)
