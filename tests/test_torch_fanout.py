"""Row 1f, the kernel's wide descent and half-cluster skip, vs the JAX package
on the CPU.

The fixture is test_binned_traversal.py::test_half_skip_matches_brute's: 160
random triangles in a K=16, T=4 kd build (C=16, S=4, half boxes in records 0
and 1), built by JAX and carried over by convert.py, and 48 rays, 40 aimed
at centroids.  Under each option the four front ends of the port
(cluster_closest_hit, binned_closest_hit, cluster_any_hit, binned_any_hit)
are held against JAX's with the Pallas kernel in interpret mode under the
same switch (_FANOUT_ENV, _HALFSKIP_ENV, patched with jax.clear_caches()
around): hit equal, t rtol 1e-5, prim equal where the nearest hit is
unique, as test_torch_traverse.py holds the defaults.  On CPU tensors the
port runs its plain version, which visits no nodes, so these tests check
the JAX kernel's 1f modes against the port's oracle and the plumbing of the
options; the CUDA kernel's 1f modes are held against the plain version in
test_torch_cuda_traverse.py and chip_smoke.py phase 8.

This file: fanout 4, the build's half boxes, the options reaching every
launch of a frame, and the refusals.  test_torch_fanout8.py and
test_torch_half_skip.py run the other two options on the same fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.scenes import random_triangles

from visionaray_torch import convert
from visionaray_torch.core.types import Ray
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.intersect import intersect_triangle
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.trace import TraceConfig, intersect_triangles_brute
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender

torch.set_num_threads(1)
CPU = "cpu"
STATICS = ("num_clusters", "cluster_size", "treelet_size", "num_treelets",
           "heap", "half_boxes")
FRONT_ENDS = ("cluster_closest_hit", "binned_closest_hit", "cluster_any_hit",
              "binned_any_hit")


def fixture_k16():
    """(JAX mesh, JAX bvh, port mesh, port bvh carried over, JAX ray, port
    ray) of the K=16, T=4 half-box fixture."""
    verts, faces = random_triangles(160, seed=11, extent=3.0, tri_size=0.7)
    jm = JMesh.create(verts, faces)
    jb = jax.jit(jbuild, static_argnames=("cluster_size", "treelet_size"))(
        jm, cluster_size=16, treelet_size=4)
    rng = np.random.default_rng(5)
    n = 48
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    cent = verts.reshape(-1, 3, 3).mean(axis=1)
    d = (cent[rng.integers(0, len(cent), n)] - o).astype(np.float32)
    d[40:] = rng.normal(size=(n - 40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mesh = convert.mesh_from_arrays(
        {f.name: (getattr(jm, f.name) if f.name == "face_normals_binding"
                  else np.asarray(getattr(jm, f.name)))
         for f in dataclasses.fields(jm)}, device=CPU)
    bvh = convert.cluster_bvh_from_arrays(
        {f.name: (getattr(jb, f.name) if f.name in STATICS
                  else np.asarray(getattr(jb, f.name)))
         for f in dataclasses.fields(jb)}, device=CPU)
    return (jm, jb, mesh, bvh, JRay(jnp.asarray(o), jnp.asarray(d)),
            Ray(torch.as_tensor(o), torch.as_tensor(d)))


@pytest.fixture(scope="module")
def k16():
    return fixture_k16()


def jax_switches(monkeypatch, fanout=2, half_skip=False):
    """The JAX package's VSNRAY_FANOUT / VSNRAY_HALFSKIP as its module
    globals read them at trace time; the caches are cleared so that no
    program traced under another setting is reused."""
    jax.clear_caches()
    monkeypatch.setattr(jtrav, "_FANOUT_ENV", "" if fanout == 2
                        else str(fanout))
    monkeypatch.setattr(jtrav, "_HALFSKIP_ENV", half_skip)


def _unique_nearest(ray, mesh):
    """Lanes whose nearest triangle is unique."""
    v1, e1, e2 = mesh.corners()
    t, _, _, hit = intersect_triangle(ray.ori[:, None], ray.dir[:, None],
                                      v1, e1, e2)
    t = torch.where(hit & (t >= 0), t, float("inf"))
    return ((t == t.min(dim=1, keepdim=True).values).sum(1) == 1).numpy()


def check_front_end(fx, name, fanout, half_skip):
    """One front end of the port under (fanout, half_skip) against JAX's
    under the same switches (already set) and against brute force."""
    jm, jb, mesh, bvh, jray, ray = fx
    brute = intersect_triangles_brute(ray, *mesh.corners(), mesh.geom_ids)
    assert int(brute.hit.sum()) >= 20
    kw = dict(fanout=fanout, half_skip=half_skip)
    if "any" in name:
        # half the hit lanes cut below their first hit
        cut = brute.hit & (torch.arange(brute.hit.shape[0]) % 2 == 0)
        mt = torch.where(cut, brute.t * 0.9, 1e30)
        extra = dict(m=3) if name.startswith("binned") else {}
        got = getattr(trav, name)(ray, bvh, mesh, mt, **extra, **kw)
        ref = getattr(jtrav, name)(jray, jb, jm, jnp.asarray(mt.numpy()),
                                   interpret=True, **extra)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(got.hit.numpy(),
                                      (brute.hit & ~cut).numpy())
        assert int(got.hit.sum()) >= 5
        return
    got = getattr(trav, name)(ray, bvh, mesh, **kw)
    ref = getattr(jtrav, name)(jray, jb, jm, interpret=True)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.hit.numpy(), brute.hit.numpy())
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    uniq = _unique_nearest(ray, mesh) & hit
    assert uniq.sum() >= 20
    np.testing.assert_array_equal(got.prim_id.numpy()[uniq],
                                  np.asarray(ref.prim_id)[uniq])


class LaunchSpy:
    """Stands in for cluster_traverse and records the (fanout, half_skip)
    and the mode of every call."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = []

    def __call__(self, *a, **k):
        self.seen.append((k.get("fanout", 2), k.get("half_skip", False),
                          ("binned_" if k.get("tile_roots") is not None
                           else "") + ("any" if k.get("any_hit") else
                                       "closest")))
        return self.fn(*a, **k)


def test_half_boxes_carried_and_built(k16):
    """The JAX build's half boxes (records 0/1, columns 10..15) reach the
    port through convert.py, and the port's own build writes the same."""
    jm, jb, mesh, bvh, _, _ = k16
    assert jb.half_boxes and bvh.half_boxes and bvh.heap
    assert (bvh.num_clusters, bvh.num_treelets) == (16, 4)
    recs = bvh.tri_records()
    jrecs = np.asarray(jb.tris).reshape(16, 16, 16)
    np.testing.assert_array_equal(recs[:, 0:2, 10:16].numpy(),
                                  jrecs[:, 0:2, 10:16])
    own = build_cluster_bvh(mesh, cluster_size=16, treelet_size=4)
    assert own.half_boxes
    np.testing.assert_array_equal(own.tris.numpy(), np.asarray(jb.tris))
    # each half box bounds the K/2 triangles of its half; a half of padding
    # (zero edges) has the empty box lo = 1e30 > hi = -1e30
    v1, e1, e2 = (recs[..., 0:3], recs[..., 3:6], recs[..., 6:9])
    pts = torch.stack([v1, v1 + e1, v1 + e2], dim=2)      # (C, K, 3, 3)
    n_empty = 0
    for h in range(2):
        lo, hi = recs[:, h, 10:13], recs[:, h, 13:16]
        half = pts[:, 8 * h:8 * (h + 1)]
        empty = lo[:, 0] > hi[:, 0]
        assert (e1[:, 8 * h:8 * (h + 1)][empty] == 0).all()
        assert (lo[empty] == 1e30).all() and (hi[empty] == -1e30).all()
        real = half[~empty].reshape(int((~empty).sum()), -1, 3)
        assert (real >= lo[~empty, None] - 1e-6).all()
        assert (real <= hi[~empty, None] + 1e-6).all()
        n_empty += int(empty.sum())
    assert n_empty == 2 * 16 - 160 // 8


@pytest.mark.parametrize("name", FRONT_ENDS)
def test_fanout4_front_ends_match_jax(k16, name, monkeypatch):
    jax_switches(monkeypatch, fanout=4)
    try:
        check_front_end(k16, name, fanout=4, half_skip=False)
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("tree", ["kd_K16", "kd_K8", "radix_K16"])
def test_config_reaches_every_launch(tree, monkeypatch):
    """A 16x16, 3-bounce NEE frame under TraceConfig(fanout=4,
    half_skip=True): every traversal gets the options the tree takes --
    both on a kd build with half boxes, fanout 4 without the skip on a K=8
    kd build (no half boxes), neither on a radix tree (JAX _fanout_for,
    _half_skip_for)."""
    K, T = {"kd_K16": (16, 16), "kd_K8": (8, 16), "radix_K16": (16, 0)}[tree]
    scene, cam = sponza_like_scene(target_tris=4000, build_bvh=False,
                                   device=CPU)
    scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=K, treelet_size=T)
    params = KernelParams.create(scene, num_bounces=3, epsilon=1e-3,
                                 bg_color=(0.2, 0.3, 0.5, 1.0),
                                 ambient_color=(1.0, 1.0, 1.0, 1.0),
                                 trace=TraceConfig(fanout=4, half_skip=True))
    spy = LaunchSpy(trav.cluster_traverse)
    monkeypatch.setattr(trav, "cluster_traverse", spy)
    x, y = trender._pixel_grid(16, 16, CPU)
    col, _ = trender.render_pixels(params, cam, x, y, 16, 16, "pathtracing",
                                   1, "jittered_blend", 1, nee=True)
    assert torch.isfinite(col).all() and float(col[:, :3].std()) > 0
    want = {"kd_K16": (4, True), "kd_K8": (4, False),
            "radix_K16": (2, False)}[tree]
    assert {s[:2] for s in spy.seen} == {want}
    modes = {s[2] for s in spy.seen}
    assert modes == ({"closest", "any"} if T == 0 else
                     {"closest", "any", "binned_closest", "binned_any"})


def test_refusals(k16):
    """The options the kernel cannot take raise ValueError."""
    _, _, mesh, bvh, _, ray = k16
    n = ray.ori.shape[0]
    rays = trav._pack_rays(ray.ori, ray.dir, torch.full((n,), 1e30), n, 4096,
                           pad_maxt=-1.0)
    args = (rays, bvh.nodes, bvh.tris, bvh.num_clusters, bvh.cluster_size,
            4096)
    for bad in (3, 16, 1):
        with pytest.raises(ValueError, match="fanout"):
            trav.cluster_traverse(*args, fanout=bad)
    # the wide and skipping forms run on this tree (plain version on CPU)
    t, p, _, _ = trav.cluster_traverse(*args, fanout=8, half_skip=True)
    assert int((p[:n] >= 0).sum()) >= 20
    # the worst-case stack: (fanout - 1) * ceil(depth / log2 fanout)
    assert [trav.stack_need(13, f) for f in (2, 4, 8)] == [13, 21, 35]
    assert trav.stack_need(64, 2) == 64 and trav.stack_need(28, 8) == 70
    radix = build_cluster_bvh(mesh, cluster_size=16)
    assert not radix.heap
    with pytest.raises(ValueError, match="stack"):
        trav.cluster_traverse(rays, radix.nodes, radix.tris,
                              radix.num_clusters, 16, 4096, heap=False,
                              depth=trav.STACK_DEPTH + 1)
    for kw in (dict(fanout=4), dict(fanout=8)):
        with pytest.raises(ValueError, match="heap"):
            trav.cluster_traverse(rays, radix.nodes, radix.tris,
                                  radix.num_clusters, 16, 4096, heap=False,
                                  depth=radix.depth, **kw)
    with pytest.raises(ValueError, match="half boxes"):
        trav.cluster_traverse(rays, radix.nodes, radix.tris,
                              radix.num_clusters, 16, 4096, heap=False,
                              depth=radix.depth, half_skip=True)
    for kw in (dict(fanout=3), dict(dir_bits=20), dict(dir_bits=-1),
               dict(shadow_m=0)):
        with pytest.raises(ValueError):
            TraceConfig(**kw)
    with pytest.raises(ValueError, match="dir_bits"):
        trav.binned_closest_hit(ray, bvh, mesh, dir_bits=20)
    assert TraceConfig() == TraceConfig(
        fanout=2, half_skip=False, dir_bits=0, shadow_m=3,
        shadow_binned=True, shadow_reversed=True)
    assert KernelParams(scene=None, epsilon=None, bg_color=None,
                        ambient_color=None).trace == TraceConfig()
