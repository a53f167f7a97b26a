"""The port's volume renderer (kernels/volume.py, scenes/volume_demo.py)
against the JAX package on the CPU, where ``volume_march`` runs its plain
version, ``march_plain``.

- ``volume_kernel`` on the same rays as JAX's (the JAX camera's primary
  rays, carried across as numpy): ``volume_scene(16)`` at 24x24 and
  ``multi_volume_scene(16, 3)`` at 32x32, hit and depth equal, colour
  atol 1e-5 (JAX's XLA contracts some products into FMAs: 2e-6 seen);
  ``render(algo="volume")`` of both scenes at the image tolerance of
  test_torch_simple.py, depth to rtol 1e-5 (the cameras' rays differ in
  the last ulp);
- a permuted volume array renders the same image (per-ray depth order);
- rays that start inside a box, and axis-aligned rays whose origin lies on
  a box plane (0 * inf = NaN in the slab test: the box is missed);
- a long thin box whose march reaches the 512-step cap;
- the plain march with ``early_exit`` (the CUDA kernel's break) equal to
  the full masked march, bit for bit;
- the scenes, ``Volumes.create``'s reshaping, convert.py's carry and the
  scene bbox (render's epsilon) equal to JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.kernels import volume as jvol
from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.scenes import volume_demo as jdemo
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.sched.render import _pixel_grid as j_pixel_grid

from visionaray_torch import convert
from visionaray_torch.core.types import Ray
from visionaray_torch.kernels import volume as tvol
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.scenes import volume_demo as tdemo
from visionaray_torch.sched import render as trender

torch.set_num_threads(1)
CPU = "cpu"
BG = (0.1, 0.4, 1.0, 1.0)
COLOR_ATOL = 1e-5

SCENES = {"single": (lambda: jdemo.volume_scene(16),
                     lambda: tdemo.volume_scene(16, device=CPU), 24),
          "multi": (lambda: jdemo.multi_volume_scene(16, 3),
                    lambda: tdemo.multi_volume_scene(16, 3, device=CPU), 32)}


def _arrays(o):
    return {f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(o)}


def _image_close(got, ref):
    """test_torch_simple.py's image tolerance."""
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    jmake, tmake, n = SCENES[request.param]
    js, jcam = jmake()
    ts, tcam = tmake()
    x, y = j_pixel_grid(n, n)
    jray = jcam.primary_rays(x, y, n, n, None)
    o, d = np.asarray(jray.ori), np.asarray(jray.dir)
    return js, jcam, ts, tcam, n, o.copy(), d.copy()


def _jax_march(jvols, o, d, step_scale=1.0):
    params = JParams.create(JScene.create(volumes=jvols), bg_color=BG)
    rec = jvol.volume_kernel(params, JRay(ori=jnp.asarray(o),
                                          dir=jnp.asarray(d)),
                             step_scale=step_scale)
    return (np.asarray(rec.color), np.asarray(rec.hit),
            np.asarray(rec.depth))


def _torch_march(tvols, o, d, step_scale=1.0, early_exit=False):
    bg = torch.tensor(BG, dtype=torch.float32)
    c, h, dep = tvol.march_plain(torch.as_tensor(o), torch.as_tensor(d),
                                 tvols, bg, step_scale, early_exit)
    return c.numpy(), h.numpy(), dep.numpy()


def _same_march(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=COLOR_ATOL)


def test_scenes_equal_jax(case):
    js, jcam, ts, tcam, *_ = case
    for f in ("lo", "hi", "texels", "transfer"):
        np.testing.assert_array_equal(getattr(ts.volumes, f).numpy(),
                                      np.asarray(getattr(js.volumes, f)))
    carried = convert.volumes_from_arrays(_arrays(js.volumes), device=CPU)
    for f in ("lo", "hi", "texels", "transfer"):
        assert torch.equal(getattr(carried, f), getattr(ts.volumes, f))
    jb, tb = js.bbox(), ts.bbox()
    np.testing.assert_array_equal(tb.lo.numpy(), np.asarray(jb.lo))
    np.testing.assert_array_equal(tb.hi.numpy(), np.asarray(jb.hi))
    for f in ("eye", "center", "up"):
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)))


def test_volume_kernel_matches_jax(case):
    js, _, ts, _, n, o, d = case
    ref = _jax_march(js.volumes, o, d)
    params = KernelParams.create(ts, bg_color=BG)
    rec = tvol.volume_kernel(params, Ray(ori=torch.as_tensor(o),
                                         dir=torch.as_tensor(d)))
    got = rec.color.numpy(), rec.hit.numpy(), rec.depth.numpy()
    _same_march(got, ref)
    assert ref[1].mean() > 0.3 and np.abs(ref[0] - np.asarray(BG)).max() > 0.1


def test_render_volume_matches_jax(case):
    js, jcam, ts, tcam, n, *_ = case
    jrt = jrender.render(js, jcam, n, n, algo="volume")
    trt = trender.render(ts, tcam, n, n, algo="volume")
    assert trt.color.shape == (n, n, 4)
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5)


def test_permuted_volumes_render_the_same(case):
    _, _, ts, tcam, n, o, d = case
    vols = ts.volumes
    perm = torch.arange(vols.num_volumes - 1, -1, -1)
    permuted = tvol.Volumes(lo=vols.lo[perm], hi=vols.hi[perm],
                            texels=vols.texels[perm],
                            transfer=vols.transfer[perm])
    ref = _torch_march(vols, o, d)
    got = _torch_march(permuted, o, d)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_early_exit_equals_masked_march(case):
    _, _, ts, _, _, o, d = case
    ref = _torch_march(ts.volumes, o, d)
    got = _torch_march(ts.volumes, o, d, early_exit=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _edge_rays():
    """Rays from inside the box, and axis-aligned rays whose origin lies on
    a box plane (the NaN slab case) or just outside it."""
    o = np.array([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0], [-0.9, 0.8, 0.5],
                  [-1.0, 0.3, -2.0], [0.2, 1.0, 3.0], [-1.0, -1.0, -3.0],
                  [1.0, 0.5, 2.5], [-1.0001, 0.3, -2.0], [0.5, -3.0, 0.5]],
                 np.float32)
    d = np.array([[0.3, -0.2, 0.9], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                  [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0],
                  [0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]],
                 np.float32)
    return o, d


def test_inside_and_nan_slab_rays_match_jax():
    js, _ = jdemo.volume_scene(16)
    ts, _ = tdemo.volume_scene(16, device=CPU)
    o, d = _edge_rays()
    ref = _jax_march(js.volumes, o, d)
    got = _torch_march(ts.volumes, o, d)
    _same_march(got, ref)
    # inside: entered at t = 0; on a box plane with d = 0 on that axis:
    # missed (NaN); just outside that plane: missed as well
    assert ref[1][:3].all() and (ref[2][:3] == 0).all()
    assert not ref[1][3:8].any()
    assert ref[1][8]


def test_long_thin_box_reaches_step_cap(monkeypatch):
    """A 2 x 0.02 x 0.02 box of 16^3 texels: dt = 0.02 / 16, so a ray along
    x needs 1600 steps and stops at MAX_STEPS = 512; the transfer is faint
    enough that alpha never saturates."""
    rng = np.random.default_rng(5)
    texels = rng.uniform(0.0, 1.0, (16, 16, 16)).astype(np.float32)
    t = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    transfer = np.stack([t, 1 - t, 0.5 + 0 * t, 0.02 * t], -1)
    lo, hi = [[-1.0, -0.01, -0.01]], [[1.0, 0.01, 0.01]]
    jv = jvol.Volumes.create(lo, hi, texels, transfer)
    tv = tvol.Volumes.create(lo, hi, texels, transfer, device=CPU)
    assert tuple(tv.texels.shape) == (1, 16, 16, 16)
    assert tuple(tv.transfer.shape) == (1, 8, 4)
    o = np.array([[-2.0, 0.0, 0.0], [-2.0, 0.003, -0.002],
                  [2.0, 0.001, 0.0]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
                 np.float32)
    ref = _jax_march(jv, o, d)
    got = _torch_march(tv, o, d)
    _same_march(got, ref)
    # the cap binds: without it every ray marches on and its colour moves
    monkeypatch.setattr(tvol, "MAX_STEPS", 2048)
    longer = _torch_march(tv, o, d)
    assert (np.abs(longer[0] - got[0]).max(-1) > 1e-2).all()


def test_volume_gradients_on_the_plain_version():
    """The plain march is differentiable with respect to the texels (the
    CUDA kernel refuses, tests/test_torch_cuda_volume.py)."""
    ts, _ = tdemo.volume_scene(8, device=CPU)
    vols = ts.volumes
    texels = vols.texels.clone().requires_grad_()
    o = torch.tensor([[2.2, 1.6, 2.4]]).expand(4, 3).contiguous()
    d = -o / o.norm(dim=-1, keepdim=True) + torch.tensor(
        [[0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0],
         [0.0, 0.0, 0.05]])
    c, _, _ = tvol.volume_march(o, d, dataclasses.replace(vols,
                                                          texels=texels),
                                torch.tensor(BG))
    c[:, :3].sum().backward()
    assert torch.isfinite(texels.grad).all() and texels.grad.abs().sum() > 0


def test_volume_refusals():
    ts, tcam = tdemo.volume_scene(8, device=CPU)
    with pytest.raises(ValueError, match="Volumes"):
        trender.render(dataclasses.replace(ts, volumes=None), tcam, 4, 4,
                       algo="volume")
    o = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="bg"):
        tvol.volume_march(o, o, ts.volumes, torch.zeros(3))
    # the kernel's flat texel index is an int32: 2^31 texels are refused
    # (shapes only, on the meta device)
    big = torch.empty((1, 1024, 1024, 2048), device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        tvol.Volumes.create([[0, 0, 0]], [[1, 1, 1]], big,
                            torch.empty((8, 4), device="meta"),
                            device="meta")
