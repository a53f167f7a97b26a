"""The port's spectral rendering (shading/spectrum.py, spd_data.py,
``Materials.to_spectral``, ``cornell_box_spectral``, the path tracer's
spectral mode and ``render(spectral=N)``) against the JAX package on the
CPU.

- every function of spectrum.py on the same inputs, at rtol 1e-6 (atol
  1e-6 of the result's scale where a sum cancels: xyz_to_rgb's negative
  coefficients, cie_x's negative lobe);
- ``to_spectral`` and ``lift_scene`` equal to JAX's, array for array;
  ``cornell_box_spectral`` too but for its measured tables ``cd`` and
  ``ce``: they are read at ``lambdas``, which XLA's CPU code rounds
  unlike f32 arithmetic in the last ulp (6.1e-5 of 614 nm), and a steep
  curve turns that into 1.5e-6 relative; so the tables are held at rtol
  1e-6 when read at JAX's wavelengths, and at rtol 1e-5 at the port's;
- ``render(spectral=8)`` of ``tri_sphere_plane`` and
  ``cornell_box_spectral(n_samples=8)`` at 16x16 with render's
  pathtracing defaults, at the image tolerance (mean abs <= 1e-4, at most
  2% of pixels off by more than 1e-3);
- the gradient of a spectral NEE frame's mean colour with respect to the
  spectral ``cd``, against ``jax.grad``: relative L2 <= 1e-3, cosine >=
  0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.scenes import basic as jbasic
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading import spectrum as jsp

from visionaray_torch.scenes import basic as tbasic
from visionaray_torch.sched import render as trender
from visionaray_torch.shading import spectrum as tsp

torch.set_num_threads(1)
CPU = "cpu"
RTOL = 1e-6


def _close(got, ref, scale_atol=True):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    atol = 1e-6 * float(np.abs(ref).max()) if scale_atol else 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol)


def _image_close(got, ref):
    """test_torch_simple.py's image tolerance."""
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


LAM = np.concatenate([np.linspace(280.0, 860.0, 97, dtype=np.float32),
                      np.float32([300.0, 400.0, 442.0, 501.1, 599.8, 700.0,
                                  829.9, 830.0])])


@pytest.mark.parametrize("n", [1, 3, 8, 60, 300])
def test_lambdas(n):
    _close(tsp.lambdas(n, CPU), jsp.lambdas(n), scale_atol=False)


@pytest.mark.parametrize("name", ["cie_x", "cie_y", "cie_z", "d65",
                                  "cornell_white", "cornell_green",
                                  "cornell_red", "cornell_light"])
def test_spectral_curves(name):
    _close(getattr(tsp, name)(torch.as_tensor(LAM)),
           getattr(jsp, name)(jnp.asarray(LAM)))


def test_blackbody():
    lam = np.linspace(380.0, 780.0, 41, dtype=np.float32)
    for temp in (2700.0, 6504.0):
        _close(tsp.blackbody(temp, torch.as_tensor(lam)),
               jsp.blackbody(temp, jnp.asarray(lam)), scale_atol=False)


@pytest.mark.parametrize("n", [3, 8, 60, 300])
def test_conversions(n):
    rng = np.random.default_rng(n)
    spd = rng.uniform(0.0, 2.0, (5, 7, n)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (5, 7, 3)).astype(np.float32)
    t_spd, t_rgb = torch.as_tensor(spd), torch.as_tensor(rgb)
    np.testing.assert_array_equal(tsp.from_rgb(t_rgb, n).numpy(),
                                  np.asarray(jsp.from_rgb(jnp.asarray(rgb),
                                                          n)))
    _close(tsp.to_rgb(t_spd), jsp.to_rgb(jnp.asarray(spd)))
    _close(tsp.to_luminance(t_spd), jsp.to_luminance(jnp.asarray(spd)))
    _close(tsp.xyz_to_rgb(t_rgb), jsp.xyz_to_rgb(jnp.asarray(rgb)))
    if n != 3:
        _close(tsp.spd_to_rgb(t_spd), jsp.spd_to_rgb(jnp.asarray(spd)))
        _close(tsp.spd_to_luminance(t_spd),
               jsp.spd_to_luminance(jnp.asarray(spd)))
        lam = np.linspace(410.0, 690.0, n, dtype=np.float32)
        _close(tsp.spd_to_rgb(t_spd, torch.as_tensor(lam)),
               jsp.spd_to_rgb(jnp.asarray(spd), jnp.asarray(lam)))


def _fields_equal(tobj, jobj, names):
    for f in names:
        np.testing.assert_array_equal(getattr(tobj, f).numpy(),
                                      np.asarray(getattr(jobj, f)), err_msg=f)


MAT_FIELDS = [f.name for f in dataclasses.fields(tbasic.Materials)]


def test_lift_scene_and_to_spectral():
    js, _ = jbasic.tri_sphere_plane()
    ts, _ = tbasic.tri_sphere_plane(device=CPU)
    _fields_equal(ts.materials.to_spectral(8), js.materials.to_spectral(8),
                  MAT_FIELDS)
    jl, tl = jsp.lift_scene(js, 8), tsp.lift_scene(ts, 8)
    _fields_equal(tl.materials, jl.materials, MAT_FIELDS)
    _fields_equal(tl.lights, jl.lights, ["position", "cl", "kl",
                                         "attenuation"])
    assert tl.mesh is ts.mesh and tl.lights.cl.shape == (1, 8)


@pytest.mark.parametrize("n", [8, 60])
def test_cornell_box_spectral(n):
    js, jcam = jbasic.cornell_box_spectral(n_samples=n)
    ts, tcam = tbasic.cornell_box_spectral(n_samples=n, device=CPU)
    assert ts.materials.cd.shape == (4, n)
    _fields_equal(ts.materials, js.materials,
                  [f for f in MAT_FIELDS if f not in ("cd", "ce")])
    lam = torch.tensor(np.array(jsp.lambdas(n)))
    cd = torch.stack([tsp.cornell_white(lam), tsp.cornell_red(lam),
                      tsp.cornell_green(lam), torch.zeros_like(lam)])
    light = tsp.cornell_light(lam)
    _close(cd, js.materials.cd, scale_atol=False)
    _close(light / light.max(), js.materials.ce[3], scale_atol=False)
    for f in ("cd", "ce"):
        np.testing.assert_allclose(getattr(ts.materials, f).numpy(),
                                   np.asarray(getattr(js.materials, f)),
                                   rtol=1e-5, atol=0)
    _fields_equal(ts.mesh, js.mesh, ["vertices", "faces", "geom_ids"])


def test_render_spectral_tri_sphere_plane():
    js, jcam = jbasic.tri_sphere_plane()
    ts, tcam = tbasic.tri_sphere_plane(device=CPU)
    kw = dict(algo="pathtracing", spectral=8)
    jrt = jrender.render(js, jcam, 16, 16, **kw)
    trt = trender.render(ts, tcam, 16, 16, **kw)
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-4)
    # the fold through to_rgb ran: not the RGB frame
    rgb = trender.render(ts, tcam, 16, 16, algo="pathtracing")
    assert float((rgb.color - trt.color).abs().max()) > 1e-2


@pytest.mark.parametrize("nee", [False, True], ids=["no_nee", "nee"])
def test_render_cornell_box_spectral(nee):
    js, jcam = jbasic.cornell_box_spectral(n_samples=8)
    ts, tcam = tbasic.cornell_box_spectral(n_samples=8, device=CPU)
    jrt = jrender.render(js, jcam, 16, 16, algo="pathtracing", nee=nee)
    trt = trender.render(ts, tcam, 16, 16, algo="pathtracing", nee=nee)
    _image_close(trt.color.numpy(), jrt.color)
    assert float(trt.color[..., :3].std()) > 0


def test_spectral_grad_wrt_cd():
    """d mean(colour) / d cd through a 12x12, 3-bounce NEE frame of the
    spectral Cornell box (8 samples)."""
    js, jcam = jbasic.cornell_box_spectral(n_samples=8)
    ts, tcam = tbasic.cornell_box_spectral(n_samples=8, device=CPU)
    kw = dict(algo="pathtracing", bounces=3, nee=True)

    def jloss(cd):
        s = dataclasses.replace(js, materials=dataclasses.replace(
            js.materials, cd=cd))
        return jnp.mean(jrender.render(s, jcam, 12, 12, **kw).color[..., :3])

    jl, jg = jax.value_and_grad(jloss)(js.materials.cd)
    cd = ts.materials.cd.clone().requires_grad_()
    s = dataclasses.replace(ts, materials=dataclasses.replace(ts.materials,
                                                              cd=cd))
    loss = trender.render(s, tcam, 12, 12, **kw).color[..., :3].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got, ref = cd.grad.double().numpy(), np.asarray(jg, np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert rel <= 1e-3 and cos >= 0.999, (rel, cos)
