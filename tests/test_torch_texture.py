"""The port's textures (shading/texture.py, the texture hook of
shading/surface.py) against the JAX package on the CPU.

- ``tex1d``, ``tex2d`` and ``tex3d`` (scalar and 2-channel volumes) for
  every filter x address mode on seeded texels and coordinates spread
  over [-0.6, 1.6] (every mode's out-of-range path): atol 1e-6, cubic
  filters 1e-5 (16 and 64 weighted taps summed);
- ``prefilter_bspline`` along 1, 2 and 3 axes, rtol 1e-5 (the causal
  start is a 12-term tensordot, whose sum order XLA picks);
- ``TextureAtlas.pack``: texels and enabled equal (with the host
  nearest-resize), and under BSPLINE_INTERPOL within rtol 1e-5;
- ``sample_scene_texture`` for every filter x address mode, one material
  without a texture (it samples white), atol 1e-6 (cubic 1e-5);
- texel and UV gradients of tex2d (LINEAR, CARDINAL_SPLINE, BSPLINE
  under MIRROR and BORDER) against ``jax.grad``: relative L2 <= 1e-5;
- test_textures_golden.py's textured quad through ``render``: the simple,
  Whitted and NEE path-traced frames (and the NEE frame in spectral mode,
  where the hook lifts the texel through from_rgb) against JAX at the
  image tolerance (mean abs <= 1e-4, at most 2% of pixels off by more
  than 1e-3); the textured frame differs from the untextured one; an
  all-white enabled atlas gives the untextured frame bit for bit under
  NEAREST, and within rtol 1e-6 under LINEAR (whose four weights sum to 1
  only within an ulp);
- the gradient of a simple frame with respect to the atlas' texels
  through ``render`` (this needs ``_grad_scope`` to see the texture)
  against ``jax.grad``: relative L2 <= 1e-4, cosine >= 0.9999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.camera import Pinhole as JPinhole
from visionaray_tpu.core.scene import Scene as JScene
from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading import texture as jtex
from visionaray_tpu.shading.lights import PointLights as JPointLights
from visionaray_tpu.shading.materials import Materials as JMaterials

from visionaray_torch import convert
from visionaray_torch.sched import render as trender
from visionaray_torch.shading import texture as ttex

torch.set_num_threads(1)
CPU = "cpu"
FILTERS = list(jtex.Filter)
MODES = list(jtex.AddressMode)


def _atol(filt):
    return 1e-6 if filt in (jtex.Filter.NEAREST, jtex.Filter.LINEAR) \
        else 1e-5


def _image_close(got, ref):
    """test_torch_simple.py's image tolerance."""
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


def _coords(rng, shape):
    return rng.uniform(-0.6, 1.6, shape).astype(np.float32)


@pytest.mark.parametrize("mode", MODES, ids=[m.name for m in MODES])
@pytest.mark.parametrize("filt", FILTERS, ids=[f.name for f in FILTERS])
def test_tex_functions_match_jax(filt, mode):
    rng = np.random.default_rng(10 * int(filt) + int(mode))
    t1 = rng.uniform(0, 1, (9, 3)).astype(np.float32)
    t2 = rng.uniform(0, 1, (7, 5, 3)).astype(np.float32)
    t3 = rng.uniform(0, 1, (5, 4, 6)).astype(np.float32)
    t3c = rng.uniform(0, 1, (5, 4, 6, 2)).astype(np.float32)
    u, v, w = (_coords(rng, (40,)) for _ in range(3))
    T, J = torch.as_tensor, jnp.asarray
    kw = dict(filter=filt, address_mode=mode, border_value=0.25)
    atol = _atol(filt)
    pairs = [
        (ttex.tex1d(T(t1), T(u), **kw), jtex.tex1d(J(t1), J(u), **kw)),
        (ttex.tex2d(T(t2), T(u), T(v), **kw),
         jtex.tex2d(J(t2), J(u), J(v), **kw)),
        (ttex.tex3d(T(t3), T(u), T(v), T(w), **kw),
         jtex.tex3d(J(t3), J(u), J(v), J(w), **kw)),
        (ttex.tex3d(T(t3c), T(u), T(v), T(w), **kw),
         jtex.tex3d(J(t3c), J(u), J(v), J(w), **kw)),
    ]
    for got, ref in pairs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("shape,ndim", [((11, 3), 1), ((9, 7, 3), 2),
                                        ((5, 6, 4), 3), ((3, 14), None)])
def test_prefilter_bspline(shape, ndim):
    rng = np.random.default_rng(len(shape))
    x = rng.uniform(0, 1, shape).astype(np.float32)
    got = ttex.prefilter_bspline(torch.as_tensor(x), ndim)
    ref = jtex.prefilter_bspline(jnp.asarray(x), ndim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _images(rng):
    return {0: rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
            2: rng.uniform(0, 1, (10, 24, 4)).astype(np.float32)}


@pytest.mark.parametrize("filt", [jtex.Filter.LINEAR,
                                  jtex.Filter.BSPLINE_INTERPOL])
def test_atlas_pack(filt):
    imgs = _images(np.random.default_rng(3))
    j = jtex.TextureAtlas.pack(imgs, 3, resolution=16, filter=filt,
                               address_mode=jtex.AddressMode.MIRROR)
    t = ttex.TextureAtlas.pack(imgs, 3, resolution=16, filter=filt,
                               address_mode=jtex.AddressMode.MIRROR,
                               device=CPU)
    assert (t.filter, t.address_mode) == (int(filt), 1)
    np.testing.assert_array_equal(t.enabled.numpy(), np.asarray(j.enabled))
    if filt == jtex.Filter.LINEAR:
        np.testing.assert_array_equal(t.texels.numpy(), np.asarray(j.texels))
    else:
        np.testing.assert_allclose(t.texels.numpy(), np.asarray(j.texels),
                                   rtol=1e-5, atol=1e-6)
    carried = convert.texture_atlas_from_arrays(
        {"texels": np.asarray(j.texels), "enabled": np.asarray(j.enabled),
         "filter": j.filter, "address_mode": j.address_mode}, device=CPU)
    assert (carried.filter, carried.address_mode) == (t.filter,
                                                      t.address_mode)
    assert carried.enabled.dtype == torch.bool


@pytest.mark.parametrize("mode", MODES, ids=[m.name for m in MODES])
@pytest.mark.parametrize("filt", FILTERS, ids=[f.name for f in FILTERS])
def test_sample_scene_texture(filt, mode):
    rng = np.random.default_rng(7 + int(filt))
    imgs = _images(rng)
    j = jtex.TextureAtlas.pack(imgs, 3, resolution=8, filter=filt,
                               address_mode=mode)
    t = convert.texture_atlas_from_arrays(
        {"texels": np.asarray(j.texels), "enabled": np.asarray(j.enabled),
         "filter": j.filter, "address_mode": j.address_mode}, device=CPU)
    gid = rng.integers(-1, 4, 64).astype(np.int32)
    uv = _coords(rng, (64, 2))
    got = ttex.sample_scene_texture(t, torch.as_tensor(gid),
                                    torch.as_tensor(uv))
    ref = jtex.sample_scene_texture(j, jnp.asarray(gid), jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=_atol(filt))
    assert (got[gid == 1] == 1.0).all()


@pytest.mark.parametrize("filt,mode", [
    (jtex.Filter.LINEAR, jtex.AddressMode.WRAP),
    (jtex.Filter.CARDINAL_SPLINE, jtex.AddressMode.MIRROR),
    (jtex.Filter.BSPLINE, jtex.AddressMode.BORDER)])
def test_tex2d_gradients(filt, mode):
    rng = np.random.default_rng(int(filt))
    tex = rng.uniform(0, 1, (6, 7, 3)).astype(np.float32)
    uv = _coords(rng, (2, 30))
    wts = rng.normal(size=(30, 3)).astype(np.float32)

    def jloss(t, uv):
        out = jtex.tex2d(t, uv[0], uv[1], filter=filt, address_mode=mode)
        return jnp.sum(out * wts)

    jgt, jguv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tex),
                                                 jnp.asarray(uv))
    tt = torch.tensor(tex, requires_grad=True)
    tuv = torch.tensor(uv, requires_grad=True)
    out = ttex.tex2d(tt, tuv[0], tuv[1], filter=filt, address_mode=mode)
    (out * torch.as_tensor(wts)).sum().backward()
    for got, ref in ((tt.grad, jgt), (tuv.grad, jguv)):
        got, ref = got.double().numpy(), np.asarray(ref, np.float64)
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


def _checker(res=32, a=(1.0, 1.0, 1.0), b=(0.1, 0.1, 0.6), tiles=4):
    """test_textures_golden.py's checker."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    m = ((xx * tiles // res) + (yy * tiles // res)) % 2
    return np.where(m[..., None] == 0, np.float32(a),
                    np.float32(b)).astype(np.float32)


def _quad(emissive=False):
    """test_textures_golden.py's textured quad, in both packages; the
    port's scene through convert.py, its atlas packed by the port."""
    verts = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                    np.float32)
    mesh = JMesh.create(verts, faces, geom_ids=np.zeros(2, np.int32),
                        tex_coords=uv)
    mats = (JMaterials.emissive(ce=(1.0, 0.8, 0.6), ls=1.0) if emissive
            else JMaterials.matte(cd=(0.9, 0.7, 0.5)))
    atlas = jtex.TextureAtlas.pack({0: _checker()}, 1, resolution=32)
    lights = JPointLights.create(position=[[0.0, 0.0, 3.0]],
                                 cl=(1.0, 1.0, 1.0), kl=1.0)
    js = JScene.create(mesh=mesh, materials=mats, lights=lights,
                       textures=atlas)
    jcam = JPinhole.create(eye=(0.0, 0.0, 3.0), center=(0.0, 0.0, 0.0),
                           up=(0.0, 1.0, 0.0), fovy=np.deg2rad(45.0),
                           aspect=1.0)

    def arrays(o):
        return {f.name: (getattr(o, f.name) if f.name ==
                         "face_normals_binding"
                         else np.asarray(getattr(o, f.name)))
                for f in dataclasses.fields(o)}

    ts = convert.scene_from_arrays(
        mesh=arrays(js.mesh), materials=arrays(js.materials),
        lights=("PointLights", arrays(js.lights)), device=CPU)
    ts = dataclasses.replace(ts, textures=ttex.TextureAtlas.pack(
        {0: _checker()}, 1, resolution=32, device=CPU))
    tcam = convert.pinhole_from_arrays(arrays(jcam), device=CPU)
    return js, jcam, ts, tcam


@pytest.mark.parametrize("algo,kw", [
    ("simple", {}), ("whitted", {}),
    ("pathtracing", dict(nee=True, bounces=3)),
    ("pathtracing", dict(nee=True, bounces=3, spectral=8))],
    ids=["simple", "whitted", "nee", "nee_spectral"])
def test_textured_frames_match_jax(algo, kw):
    js, jcam, ts, tcam = _quad()
    np.testing.assert_array_equal(ts.textures.texels.numpy(),
                                  np.asarray(js.textures.texels))
    jrt = jrender.render(js, jcam, 32, 32, algo=algo, **kw)
    trt = trender.render(ts, tcam, 32, 32, algo=algo, **kw)
    _image_close(trt.color.numpy(), jrt.color)
    plain = trender.render(dataclasses.replace(ts, textures=None), tcam, 32,
                           32, algo=algo, **kw)
    assert float((plain.color - trt.color).abs().max()) > 0.05


def test_emissive_textured_and_white_atlas():
    js, jcam, ts, tcam = _quad(emissive=True)
    _image_close(trender.render(ts, tcam, 24, 24).color.numpy(),
                 jrender.render(js, jcam, 24, 24).color)
    js, jcam, ts, tcam = _quad()
    for filt in (ttex.Filter.NEAREST, ttex.Filter.LINEAR):
        white = ttex.TextureAtlas.pack({0: np.ones((4, 4, 3), np.float32)},
                                       1, resolution=32, filter=filt,
                                       device=CPU)
        for algo in ("simple", "pathtracing"):
            got = trender.render(dataclasses.replace(ts, textures=white),
                                 tcam, 24, 24, algo=algo).color
            ref = trender.render(dataclasses.replace(ts, textures=None),
                                 tcam, 24, 24, algo=algo).color
            if filt == ttex.Filter.NEAREST:
                assert torch.equal(got, ref)
            else:   # the four bilinear weights sum to 1 within an ulp
                torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


def test_texel_gradient_through_render():
    js, jcam, ts, tcam = _quad()

    def jloss(texels):
        s = dataclasses.replace(js, textures=dataclasses.replace(
            js.textures, texels=texels))
        return jnp.mean(jrender.render(s, jcam, 16, 16).color[..., :3])

    jg = jax.grad(jloss)(js.textures.texels)
    texels = ts.textures.texels.clone().requires_grad_()
    s = dataclasses.replace(ts, textures=dataclasses.replace(
        ts.textures, texels=texels))
    trender.render(s, tcam, 16, 16).color[..., :3].mean().backward()
    assert texels.grad is not None
    got, ref = texels.grad.double().numpy(), np.asarray(jg, np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert rel <= 1e-4 and cos >= 0.9999, (rel, cos)
