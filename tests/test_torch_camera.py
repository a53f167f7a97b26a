"""The port's cameras against the JAX package on the CPU, on the pattern of
tests/test_matrix_camera.py: Pinhole's matrices and setters,
MatrixCamera's primary rays, project/unproject.

Tolerances: view and projection matrices to atol 1e-6 (the port writes
the 4x4 products out in f32, JAX runs an f32 matmul); MatrixCamera rays to
JAX's at atol 2e-5 (JAX inverts in f32, the port in f64); the pinhole and
matrix rays of one camera to test_matrix_camera.py's limits (directions
2e-5, origins on the pinhole ray within 1.5 z_near); at the 1e6 near/far
ratio, finite rays within 2e-3 of the pinhole's as in JAX's test;
project to JAX's at rtol 1e-6, the unproject round trip to atol 1e-3; a
simple frame through the matrix camera against JAX's and against the
pinhole frame at test_torch_simple.py's image tolerance (mean abs <= 1e-4,
at most 2% of pixels off by more than 1e-3: the plastic sphere's
exponent-64 highlight turns the last-ulp difference of a hit point seen
from the near plane rather than the eye into up to 2e-3 at one pixel).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core import camera as jcamera
from visionaray_tpu.core import types as jtypes
from visionaray_tpu.core import vecmath as jvec

from visionaray_torch import MatrixCamera, Pinhole, convert
from visionaray_torch.core import camera as tcamera
from visionaray_torch.core import types as ttypes
from visionaray_torch.core import vecmath as tvec
from visionaray_torch.scenes.basic import tri_sphere_plane
from visionaray_torch.sched.render import render

torch.set_num_threads(1)
CPU = "cpu"


def _cams(z_near=0.1, z_far=100.0):
    kw = dict(eye=(1.5, 2.0, 6.0), center=(0.2, -0.1, 0.0),
              fovy=np.deg2rad(50), aspect=4.0 / 3.0, z_near=z_near,
              z_far=z_far)
    return jcamera.Pinhole.create(**kw), Pinhole.create(device=CPU, **kw)


def _grid(W, H):
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (jnp.asarray(xx), jnp.asarray(yy), torch.from_numpy(xx),
            torch.from_numpy(yy))


@pytest.mark.parametrize("z", [(0.1, 100.0), (0.001, 1000.0)])
def test_matrices_match_jax(z):
    jc, tc = _cams(*z)
    np.testing.assert_allclose(tc.view_matrix().numpy(),
                               np.asarray(jc.view_matrix()), atol=1e-6)
    np.testing.assert_allclose(tc.proj_matrix().numpy(),
                               np.asarray(jc.proj_matrix()), atol=1e-6)
    mc = MatrixCamera.from_pinhole(tc)
    assert mc.view.shape == mc.proj.shape == (4, 4)


def test_setters_match_jax():
    jc, tc = _cams()
    lo, hi = (-1.0, -2.0, -0.5), (2.0, 1.0, 3.0)
    pairs = [(jc.look_at((0, 1, 5), (0, 0, 0), (0, 1, 0)),
              tc.look_at((0, 1, 5), (0, 0, 0), (0, 1, 0))),
             (jc.perspective(0.7, 1.5, 0.01, 50.0),
              tc.perspective(0.7, 1.5, 0.01, 50.0)),
             (jc.view_all(lo, hi), tc.view_all(lo, hi))]
    for j, t in pairs:
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(getattr(t, f.name).numpy(),
                                       np.asarray(getattr(j, f.name)),
                                       rtol=1e-6, err_msg=f.name)
        np.testing.assert_allclose(float(t.distance), float(j.distance),
                                   rtol=1e-6)


def test_matrix_rays_match_jax_and_pinhole():
    jc, tc = _cams()
    W, H = 64, 48
    jx, jy, tx, ty = _grid(W, H)
    rj = jcamera.MatrixCamera.from_pinhole(jc).primary_rays(jx, jy, W, H)
    mcam = MatrixCamera.from_pinhole(tc)
    rm = mcam.primary_rays(tx, ty, W, H)
    np.testing.assert_allclose(rm.dir.numpy(), np.asarray(rj.dir), atol=2e-5)
    np.testing.assert_allclose(rm.ori.numpy(), np.asarray(rj.ori), atol=2e-5)
    # the same lines as the pinhole's: equal directions, origins on the
    # pinhole ray near the eye (the matrix path starts on the near plane)
    rp = tc.primary_rays(tx, ty, W, H)
    dp = rp.dir.numpy()
    np.testing.assert_allclose(rm.dir.numpy(), dp, atol=2e-5)
    off = rm.ori.numpy() - rp.ori.numpy()
    t = (off * dp).sum(-1, keepdims=True)
    np.testing.assert_allclose(off, t * dp, atol=2e-5)
    assert (np.abs(t) <= float(tc.z_near) * 1.5 + 1e-4).all()
    # jittered rays as well
    jit = np.random.default_rng(2).uniform(-0.5, 0.5, (H, W, 2))
    rjj = jcamera.MatrixCamera.from_pinhole(jc).primary_rays(
        jx, jy, W, H, jnp.asarray(jit, jnp.float32))
    rmj = mcam.primary_rays(tx, ty, W, H,
                            torch.tensor(jit, dtype=torch.float32))
    np.testing.assert_allclose(rmj.dir.numpy(), np.asarray(rjj.dir),
                               atol=2e-5)


def test_extreme_near_far_ratio():
    """The viewer's default z range (0.001 / 1000): the far point's w
    underflows in f32, so the direction is the homogeneous difference."""
    jc, tc = _cams(z_near=0.001, z_far=1000.0)
    W, H = 16, 16
    jx, jy, tx, ty = _grid(W, H)
    rm = MatrixCamera.from_pinhole(tc).primary_rays(tx, ty, W, H)
    rp = tc.primary_rays(tx, ty, W, H)
    assert torch.isfinite(rm.dir).all()
    np.testing.assert_allclose(rm.dir.numpy(), rp.dir.numpy(), atol=2e-3)
    rj = jcamera.MatrixCamera.from_pinhole(jc).primary_rays(jx, jy, W, H)
    np.testing.assert_allclose(rm.dir.numpy(), np.asarray(rj.dir), atol=2e-3)


def test_project_unproject_match_jax_and_round_trip():
    jc, tc = _cams()
    vp = (0, 0, 640, 480)
    p = np.float32([[0.2, -0.1, 0.0], [1.0, 1.0, -2.0], [-0.7, 0.4, 1.1]])
    jwin = jcamera.project(jnp.asarray(p), jc.view_matrix(),
                           jc.proj_matrix(), vp)
    view, proj = tc.view_matrix(), tc.proj_matrix()
    twin = tcamera.project(torch.from_numpy(p), view, proj, vp)
    np.testing.assert_allclose(twin.numpy(), np.asarray(jwin), rtol=1e-6)
    back = tcamera.unproject(twin, view, proj, vp)
    np.testing.assert_allclose(back.numpy(), p, atol=1e-3)
    jback = jcamera.unproject(jwin, jc.view_matrix(), jc.proj_matrix(), vp)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), atol=1e-3)


def _image_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


def test_rendered_frame_matches_jax_and_pinhole():
    from visionaray_tpu.scenes import tri_sphere_plane as j_tsp
    from visionaray_tpu.sched.render import render as jrender
    scene, _ = tri_sphere_plane(device=CPU)
    jc, cam = _cams()
    rt_p = render(scene, cam, 32, 24, algo="simple")
    rt_m = render(scene, MatrixCamera.from_pinhole(cam), 32, 24,
                  algo="simple")
    jrt = jrender(j_tsp()[0], jcamera.MatrixCamera.from_pinhole(jc), 32, 24,
                  algo="simple")
    _image_close(rt_m.color.numpy(), jrt.color)
    _image_close(rt_m.color.numpy(), rt_p.color.numpy())


def test_convert_carries_matrix_camera():
    jc, _ = _cams()
    jm = jcamera.MatrixCamera.from_pinhole(jc)
    tm = convert.matrix_camera_from_arrays(
        {f.name: np.asarray(getattr(jm, f.name))
         for f in dataclasses.fields(jm)}, device=CPU)
    np.testing.assert_array_equal(tm.view.numpy(), np.asarray(jm.view))
    np.testing.assert_array_equal(tm.proj.numpy(), np.asarray(jm.proj))


def test_vecmath_and_aabb_helpers_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(6, 3)).astype(np.float32)
    n = rng.normal(size=(6, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    a[0] = 0.0
    ja, jn, jm = jnp.asarray(a), jnp.asarray(n), jnp.asarray(m)
    ta, tn, tm = (torch.from_numpy(x) for x in (a, n, m))
    np.testing.assert_allclose(tvec.safe_normalize(ta).numpy(),
                               np.asarray(jvec.safe_normalize(ja)),
                               rtol=1e-6)
    for eta in (0.67, 1.5):   # 1.5: total internal reflection on some
        np.testing.assert_allclose(tvec.refract(ta, tn, eta).numpy(),
                                   np.asarray(jvec.refract(ja, jn, eta)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvec.transform_point(tm, ta).numpy(),
                               np.asarray(jvec.transform_point(jm, ja)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvec.transform_vector(tm, ta).numpy(),
                               np.asarray(jvec.transform_vector(jm, ja)),
                               rtol=1e-5, atol=1e-6)
    jb = jtypes.AABB.empty().insert(jtypes.AABB(ja[1:3].min(0),
                                                ja[1:3].max(0)))
    tb = ttypes.AABB.empty(device=CPU).insert(
        ttypes.AABB(ta[1:3].amin(0), ta[1:3].amax(0)))
    for f in ("lo", "hi"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    np.testing.assert_array_equal(tb.center().numpy(),
                                  np.asarray(jb.center()))
    np.testing.assert_array_equal(tb.size().numpy(), np.asarray(jb.size()))
    hr = ttypes.HitRecord.none((6,), CPU)
    hr.t = torch.full((6,), 2.0)
    np.testing.assert_array_equal(
        hr.isect_pos(ttypes.Ray(ori=ta, dir=tn)).numpy(), a + 2.0 * n)


def test_radical_inverse_matches_jax():
    from visionaray_tpu.ops.sampling import radical_inverse as j_ri

    from visionaray_torch.ops.sampling import radical_inverse as t_ri
    n = np.random.default_rng(0).integers(0, 2 ** 32, 512, dtype=np.uint64)
    n = np.concatenate([n, [0, 1, 2 ** 32 - 1]]).astype(np.uint32)
    for base in (2, 3, 5):
        np.testing.assert_array_equal(
            t_ri(torch.from_numpy(n.astype(np.int64)), base).numpy(),
            np.asarray(j_ri(jnp.asarray(n), base)))
