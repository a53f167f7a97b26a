"""The port's path tracer vs the JAX package on the CPU.

The slice: render_pixels on sponza_like(4000) (4,804 triangles) with a
K=8, T=16 treelet ClusterBVH (C=1024 clusters, S=64 treelets), 24x24
pixels, 3 bounces, NEE, frame 1 -- the configuration of
__graft_entry__.py's dry run -- so bounce 0 runs coherent closest-hit and
any-hit and bounces 1-2 the binned two-pass path.  Each side builds its own
scene and BVH.  Tolerance: mean absolute difference <= 1e-4 and at most 2%
of pixels off by more than 1e-3 (a flipped edge hit reroutes a whole
path).  Measured on this configuration: mean 5.1e-8, max 3.3e-6, no pixel
over 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.scenes import tri_sphere_plane as j_tri_sphere_plane
from visionaray_tpu.sched import render as jrender
from visionaray_tpu.shading import lights as jlights
from visionaray_tpu.shading.materials import Materials as JMaterials

from visionaray_torch import convert
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender

torch.set_num_threads(1)
CPU = "cpu"
W = H = 24


def _image_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


def test_slice_render_pixels_matches_jax(monkeypatch):
    js, jcam = j_sponza(target_tris=4000, build_bvh=False)
    js = dataclasses.replace(js, bvh=jbuild(js.mesh, cluster_size=8,
                                            treelet_size=16))
    ts, tcam = sponza_like_scene(target_tris=4000, device=CPU)
    ts.bvh = build_cluster_bvh(ts.mesh, cluster_size=8, treelet_size=16)
    assert (ts.bvh.num_clusters, ts.bvh.num_treelets) == (1024, 64)
    kw = dict(num_bounces=3, epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
              ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = jrender._pixel_grid(W, H)
    jcol, jdepth = jrender.render_pixels(
        JParams.create(js, **kw), jcam, x, y, W, H, "pathtracing", 1,
        "jittered_blend", jnp.uint32(1), nee=True)

    # count which traversal modes the port's slice drives (CPU: the plain
    # version behind the kernel wrapper)
    seen = []
    real = trav.cluster_traverse

    def spy(*a, **k):
        seen.append(("binned_" if k.get("tile_roots") is not None else "")
                    + ("any" if k.get("any_hit") else "closest"))
        return real(*a, **k)

    monkeypatch.setattr(trav, "cluster_traverse", spy)
    tx, ty = trender._pixel_grid(W, H, CPU)
    col, depth = trender.render_pixels(
        KernelParams.create(ts, **kw), tcam, tx, ty, W, H, "pathtracing", 1,
        "jittered_blend", 1, nee=True)
    assert set(seen) == {"closest", "any", "binned_closest", "binned_any"}
    assert col.shape == (W * H, 4)
    _image_close(col.numpy(), jcol)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5)
    assert float(col[:, :3].std()) > 0


def _mixed_light_scenes():
    """tri_sphere_plane (triangle, sphere, plane) plus a mirror and an
    emissive triangle, lit by a point, a spot and a rect area light."""
    js, jcam = j_tri_sphere_plane()
    mats = JMaterials.concatenate([
        js.materials, JMaterials.mirror(cr=(0.9, 0.9, 0.9)),
        JMaterials.emissive(ce=(1.0, 0.9, 0.7), ls=3.0)])
    mesh = js.mesh
    verts = np.concatenate([np.asarray(mesh.vertices),
                            [[0.5, 0.0, -1.5], [1.8, 0.0, -1.4],
                             [1.2, 1.3, -1.6], [-1.8, 1.5, -0.5],
                             [-1.2, 1.5, -0.4], [-1.5, 2.2, -0.5]]])
    faces = np.concatenate([np.asarray(mesh.faces), [[3, 4, 5], [6, 7, 8]]])
    from visionaray_tpu.core.scene import TriangleMesh as JMesh
    jmesh = JMesh.create(verts.astype(np.float32), faces.astype(np.int32),
                         geom_ids=np.array([0, 3, 4], np.int32))
    lights = (js.lights,
              jlights.SpotLights.create((0.0, 3.0, 1.0), (0.0, -1.0, -0.3),
                                        cutoff_deg=35.0, exponent=2.0),
              jlights.AreaLights.rect((-0.5, 2.5, -0.5), (1.0, 0.0, 0.0),
                                      (0.0, 0.0, 1.0), kl=2.0))
    js = dataclasses.replace(js, mesh=jmesh, materials=mats, lights=lights)

    def arrays(o):
        return {f.name: (getattr(o, f.name)
                         if f.name == "face_normals_binding"
                         else np.asarray(getattr(o, f.name)))
                for f in dataclasses.fields(o)}

    ts = convert.scene_from_arrays(
        mesh=arrays(js.mesh), spheres=arrays(js.spheres),
        planes=arrays(js.planes), materials=arrays(js.materials),
        lights=[(type(g).__name__, arrays(g)) for g in lights], device=CPU)
    tcam = convert.pinhole_from_arrays(arrays(jcam), device=CPU)
    return js, jcam, ts, tcam


@pytest.mark.parametrize("nee", [True, False], ids=["nee", "no_nee"])
def test_render_front_end_matches_jax(nee):
    """render(): brute-force triangles, spheres, planes, three light kinds,
    mirror and emissive materials, and the progressive blend into a
    RenderTarget at frame 2."""
    js, jcam, ts, tcam = _mixed_light_scenes()
    kw = dict(algo="pathtracing", spp=1, bounces=3, nee=nee, frame_num=2)
    jrt = jrender.render(js, jcam, 12, 10, **kw)
    jrt2 = jrender.render(js, jcam, 12, 10, rt=jrt, **kw)
    trt = trender.render(ts, tcam, 12, 10, **kw)
    trt2 = trender.render(ts, tcam, 12, 10, rt=trt, **kw)
    assert trt2.color.shape == (10, 12, 4)
    _image_close(trt.color.numpy(), jrt.color)
    _image_close(trt2.color.numpy(), jrt2.color)
    np.testing.assert_allclose(trt2.depth.numpy(), np.asarray(jrt2.depth),
                               rtol=1e-5)


def test_unported_options_raise():
    ts, tcam = sponza_like_scene(target_tris=4000, device=CPU)
    with pytest.raises(NotImplementedError, match="pathtracing"):
        trender.render(ts, tcam, 4, 4, algo="volume")
    with pytest.raises(NotImplementedError):
        trender.render(ts, tcam, 4, 4, spectral=8)
    with pytest.raises(NotImplementedError, match="LBVH"):
        trender.render(dataclasses.replace(ts, bvh=object()), tcam, 4, 4)
    with pytest.raises(NotImplementedError, match="RenderTarget"):
        trender.render(ts, tcam, 4, 4, rt=object())
    assert trender._ssaa_offsets(4) == jrender._ssaa_offsets(4)
    assert trender._ssaa_offsets(3) == jrender._ssaa_offsets(3)
