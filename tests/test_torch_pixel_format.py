"""The port's pixel formats (visionaray_torch/io/pixel_format.py) against
the JAX package's on the CPU, for every format of PIXEL_FORMATS:

- the host functions (a numpy copy): ``convert`` from RGBA32F and back,
  ``store`` and ``blend``, equal to JAX's;
- the device functions: ``convert_device`` from RGBA32F (values in
  [-0.2, 1.2], and large values in [-4e4, 7e4] that saturate the integer
  formats and overflow the half floats) and back, ``blend_device`` into a
  ``make_typed_render_target`` of the format: equal to JAX's, integer and
  float formats alike (no float format differs on these inputs; the
  stored half floats are compared as values, inf included).  A packed
  format's target holds one word a pixel in the port; JAX's holds C
  words, which its own ``blend_device`` cannot unpack, so its blend runs
  on a one-word plane here;
- ``render(..., rt=TypedRenderTarget)``: four progressive RGBA8 frames of
  ``tri_sphere_plane`` (jittered samples, so each frame differs) blended
  on the device, against JAX's: a quantized byte may differ by 1 where
  the float images differ in their last bits (at most 1% of the bytes),
  and the depth plane to 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.io import pixel_format as jpf
from visionaray_tpu.scenes import tri_sphere_plane as j_tsp
from visionaray_tpu.sched import render as jrender

from visionaray_torch.io import pixel_format as tpf
from visionaray_torch.scenes import tri_sphere_plane as t_tsp
from visionaray_torch.sched import render as trender

torch.set_num_threads(1)
CPU = "cpu"
FORMATS = list(jpf.PIXEL_FORMATS)


def _values(x):
    """A tensor or array as float64 values (unsigned tensors widened)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.uint16, torch.uint32, torch.uint64):
            x = x.to(torch.int64)
        x = x.numpy()
    return np.asarray(x).astype(np.float64)


def _equal(got, ref):
    g, r = _values(got), _values(ref)
    assert g.shape == r.shape
    np.testing.assert_array_equal(g, r)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.2, (6, 7, 4)).astype(np.float32)
    x[0, 0] = (0.0, 1.0, 0.5, 1.0)
    big = rng.uniform(-4e4, 7e4, (6, 7, 4)).astype(np.float32)
    return x, big


def test_table_matches_jax():
    assert list(tpf.PIXEL_FORMATS) == FORMATS
    for name in FORMATS:
        assert dataclasses.asdict(tpf.PIXEL_FORMATS[name]) == \
            dataclasses.asdict(jpf.PIXEL_FORMATS[name])
        assert tpf.PIXEL_FORMATS[name].size_bytes == \
            jpf.PIXEL_FORMATS[name].size_bytes


@pytest.mark.parametrize("fmt", FORMATS)
def test_host_functions_match_jax(fmt):
    x, _ = _inputs()
    q = tpf.convert(x, "RGBA32F", fmt)
    _equal(q, jpf.convert(x, "RGBA32F", fmt))
    _equal(tpf.convert(q, fmt, "RGBA32F"), jpf.convert(q, fmt, "RGBA32F"))
    jt, tt = np.zeros_like(q), np.zeros_like(q)
    _equal(tpf.store(tt, x, "RGBA32F", fmt), jpf.store(jt, x, "RGBA32F",
                                                        fmt))
    y = np.random.default_rng(1).uniform(0, 1, x.shape).astype(np.float32)
    _equal(tpf.blend(tt, y, "RGBA32F", fmt, 0.25, 0.75),
           jpf.blend(jt, y, "RGBA32F", fmt, 0.25, 0.75))


@pytest.mark.parametrize("fmt", FORMATS)
def test_convert_device_matches_jax(fmt):
    for x in _inputs():
        j = jpf.convert_device(jnp.asarray(x), "RGBA32F", fmt)
        t = tpf.convert_device(torch.as_tensor(x), "RGBA32F", fmt)
        assert t.dtype == tpf.torch_dtype(tpf.PIXEL_FORMATS[fmt])
        _equal(t, j)
        _equal(tpf.convert_device(t, fmt, "RGBA32F"),
               jpf.convert_device(j, fmt, "RGBA32F"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_blend_device_matches_jax(fmt):
    x, _ = _inputs()
    h, w = x.shape[:2]
    jt = jpf.make_typed_render_target(w, h, fmt)
    tt = tpf.make_typed_render_target(w, h, fmt, device=CPU)
    if jpf.PIXEL_FORMATS[fmt].packed_bits:
        # JAX's target holds C words a pixel, which its blend_device
        # cannot unpack; the port's holds one (ROADMAP, Queue 3): JAX's
        # blend on a one-word plane is the reference
        jt = dataclasses.replace(jt, color=jnp.zeros((h, w), jnp.uint32))
    assert tuple(tt.color.shape) == tuple(jt.color.shape)
    _equal(tt.color, jt.color)
    for frame in (1, 2, 3):
        img = np.roll(x, frame, axis=1)
        a = 1.0 / frame
        jt = jpf.blend_device(jt, jnp.asarray(img), a, 1.0 - a)
        tt = tpf.blend_device(tt, torch.as_tensor(img), a, 1.0 - a)
        _equal(tt.color, jt.color)
    _equal(tt.as_float(), jt.as_float())
    jt = jpf.store_device(jt, jnp.asarray(x))
    tt = tpf.store_device(tt, torch.as_tensor(x))
    _equal(tt.color, jt.color)


def test_progressive_typed_target_matches_jax():
    js, jcam = j_tsp()
    ts, tcam = t_tsp(device=CPU)
    w, h = 24, 16
    jrt = jpf.make_typed_render_target(w, h, "RGBA8")
    trt = tpf.make_typed_render_target(w, h, "RGBA8", device=CPU)
    frames = []
    for frame in range(1, 5):
        jrt = jrender.render(js, jcam, w, h, pixel_sampler="jittered",
                             frame_num=frame, rt=jrt)
        trt = trender.render(ts, tcam, w, h, pixel_sampler="jittered",
                             frame_num=frame, rt=trt)
        assert isinstance(trt, tpf.TypedRenderTarget)
        assert trt.color.dtype == torch.uint8
        frames.append(trt.color.clone())
    diff = np.abs(_values(trt.color) - _values(jrt.color))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5, atol=1e-6)
    # the frames differ (jittered) and the target holds their blend
    assert not torch.equal(frames[0], frames[-1])
    assert float(trt.as_float()[..., :3].std()) > 0
