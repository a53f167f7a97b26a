"""The port's simple kernel and ``render``'s per-algorithm defaults vs the
JAX package on the CPU.

- ``render(scene, cam, w, h)`` with defaults only (the simple kernel,
  4 bounces, ambient 0, the uniform pixel sampler) on tri_sphere_plane
  carried over with convert.py, in both packages: colours to
  test_torch_pathtracing.py's image tolerance (mean abs <= 1e-4, at most
  2% of pixels off by more than 1e-3) and depths to rtol 1e-5; and to
  tests/oracle.py's scalar render_simple as test_golden_simple.py holds
  the JAX package.
- ``render(..., algo="simple")`` on sponza_like(2000) with a radix-tree
  ClusterBVH (treelet_size=0, K=8), each package building its own scene
  and tree: one coherent closest-hit launch on the radix tree (PERF.md
  row 1e; on the CPU the wrapper's plain version) against the JAX
  package's Pallas kernel in interpret mode.
- The bounces, ambient colour and pixel sampler that each package's
  ``render`` picks for simple, pathtracing, whitted and ao, read without
  rendering.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.scenes import tri_sphere_plane as j_tri_sphere_plane
from visionaray_tpu.sched import render as jrender

from visionaray_torch import convert
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender

torch.set_num_threads(1)
CPU = "cpu"


def _image_close(got, ref):
    """test_torch_pathtracing.py's image tolerance."""
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


def _arrays(o):
    return {f.name: (getattr(o, f.name) if f.name == "face_normals_binding"
                     else np.asarray(getattr(o, f.name)))
            for f in dataclasses.fields(o)}


def test_render_defaults_match_jax_and_oracle():
    W, H = 32, 24
    js, jcam = j_tri_sphere_plane()
    ts = convert.scene_from_arrays(
        mesh=_arrays(js.mesh), spheres=_arrays(js.spheres),
        planes=_arrays(js.planes), materials=_arrays(js.materials),
        lights=(type(js.lights).__name__, _arrays(js.lights)), device=CPU)
    tcam = convert.pinhole_from_arrays(_arrays(jcam), device=CPU)
    jrt = jrender.render(js, jcam, W, H)
    trt = trender.render(ts, tcam, W, H)
    assert trt.color.shape == (H, W, 4) and trt.depth.shape == (H, W)
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5)
    # the scalar oracle, as test_golden_simple.py holds the JAX package
    ref = oracle.render_simple(oracle.scene_to_np(js), oracle.cam_to_np(jcam),
                               W, H)
    diff = np.abs(trt.color.numpy() - ref.astype(np.float32))
    assert np.mean(np.any(diff > 1e-3, axis=-1)) < 0.005
    assert diff.mean() < 1e-4
    assert float((trt.depth > 0).float().mean()) > 0.3


def test_simple_on_radix_tree_matches_jax(monkeypatch):
    W, H = 24, 16
    js, jcam = j_sponza(target_tris=2000, build_bvh=False)
    js = dataclasses.replace(js, bvh=jbuild(js.mesh, cluster_size=8,
                                            treelet_size=0))
    ts, tcam = sponza_like_scene(target_tris=2000, build_bvh=False,
                                 device=CPU)
    ts.bvh = build_cluster_bvh(ts.mesh, cluster_size=8, treelet_size=0)
    assert not ts.bvh.heap and ts.bvh.num_clusters == js.bvh.num_clusters
    jrt = jrender.render(js, jcam, W, H, algo="simple")

    seen = []
    real = trav.cluster_traverse

    def spy(*a, **k):
        seen.append(trav.launch_mode(k.get("heap", True), a[3],
                                     k.get("tile_roots") is not None,
                                     k.get("any_hit", False)))
        return real(*a, **k)

    monkeypatch.setattr(trav, "cluster_traverse", spy)
    trt = trender.render(ts, tcam, W, H, algo="simple")
    assert seen == ["radix_closest"]
    _image_close(trt.color.numpy(), jrt.color)
    np.testing.assert_allclose(trt.depth.numpy(), np.asarray(jrt.depth),
                               rtol=1e-5)
    hit = trt.depth.numpy() > 0
    assert 0.5 < hit.mean() and np.array_equal(hit, np.asarray(jrt.depth) > 0)


@pytest.mark.parametrize("algo", ["simple", "pathtracing", "whitted", "ao"])
def test_defaults_per_algorithm_match_jax(algo, monkeypatch):
    """What each render fills in for bounces, ambient and the pixel
    sampler: the JAX package's read from its render with the frame itself
    stubbed out, the port's from ``algo_defaults`` and, for the ported
    kernels, from its render stubbed the same way."""
    got = {}

    def stub(key, zeros):
        def frame(params, cam, width, height, algo, spp, pixel_sampler,
                  *a, **k):
            got[key] = (params.num_bounces,
                        tuple(np.asarray(params.ambient_color).tolist()),
                        pixel_sampler)
            return zeros((height, width, 4)), zeros((height, width))
        return frame

    monkeypatch.setattr(jrender, "_render_frame", stub("jax", jnp.zeros))
    js, jcam = j_tri_sphere_plane()
    jrender.render(js, jcam, 4, 4, algo=algo)
    assert trender.algo_defaults(algo) == (got["jax"][0],
                                           tuple(got["jax"][1]),
                                           got["jax"][2])
    if algo in trender.KERNELS:
        monkeypatch.setattr(trender, "_render_frame",
                            stub("torch", torch.zeros))
        ts, tcam = sponza_like_scene(target_tris=500, device=CPU)
        trender.render(ts, tcam, 4, 4, algo=algo)
        assert got["torch"] == got["jax"]
    else:
        ts, tcam = sponza_like_scene(target_tris=500, device=CPU)
        with pytest.raises(NotImplementedError, match="pathtracing"):
            trender.render(ts, tcam, 4, 4, algo=algo)
