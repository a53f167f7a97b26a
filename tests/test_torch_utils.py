"""The port's utilities (visionaray_torch/utils/) against the JAX
package's on the CPU:

- ``bvh_debug``: ``node_depths``, ``bvh_stats`` and the outline image of
  the same LBVH and of the same treelet ClusterBVH (JAX's build, carried
  across by convert.py) equal to JAX's, and ``dump_bvh``'s file;
- ``metrics``: ``bounce_histogram`` counts on the Cornell box equal to
  JAX's (the same rays and sampler seeds), ``frame_metrics``,
  ``scaling_efficiency``, ``MetricsLog``, ``Timer``, ``FrameCounter`` and
  ``memory_stats`` (empty on the CPU);
- ``checkpoint``: round trips of render targets (float and typed), nested
  trees and an Adam optimizer's state, a ``RenderCheckpoint`` written by
  JAX loaded by the port and one written by the port loaded by JAX, the
  same leaves either way;
- ``cache``: the kernel build directory it names.
"""

import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.ops import lbvh as jl
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh
from visionaray_tpu.ops.sampling import Sampler as JSampler
from visionaray_tpu.scenes import cornell_box as j_cornell
from visionaray_tpu.scenes import random_triangles
from visionaray_tpu.sched.render import RenderTarget as JRenderTarget
from visionaray_tpu.sched.render import _pixel_grid as j_pixel_grid
from visionaray_tpu.utils import bvh_debug as jdbg
from visionaray_tpu.utils import checkpoint as jck
from visionaray_tpu.utils import metrics as jmetrics

from visionaray_torch import convert
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.io.pixel_format import make_typed_render_target
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import lbvh as tl
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.scenes import cornell_box as t_cornell
from visionaray_torch.sched.render import RenderTarget
from visionaray_torch.utils import bvh_debug as tdbg
from visionaray_torch.utils import cache as tcache
from visionaray_torch.utils import checkpoint as tck
from visionaray_torch.utils import metrics as tmetrics

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module")
def trees():
    verts, faces = random_triangles(n=300, seed=3, extent=4.0,
                                    tri_size=1.0)
    jm = JMesh.create(verts, faces)
    tm = TriangleMesh.create(verts, faces, device=CPU)
    jc = build_cluster_bvh(jm, cluster_size=8, treelet_size=4)
    tc = convert.cluster_bvh_from_arrays(
        {f.name: np.asarray(getattr(jc, f.name))
         if not isinstance(getattr(jc, f.name), (int, bool)) else
         getattr(jc, f.name) for f in dataclasses.fields(jc)}, device=CPU)
    return {"lbvh": (jl.build_lbvh(jm), tl.build_lbvh(tm)),
            "cluster": (jc, tc)}


@pytest.mark.parametrize("kind", ["lbvh", "cluster"])
def test_bvh_debug_matches_jax(trees, kind):
    jb, tb = trees[kind]
    td, tmax = tdbg.node_depths(tb)
    jd, jmax = jdbg.node_depths(jb)
    np.testing.assert_array_equal(td, jd)
    assert tmax == jmax > 0
    assert tdbg.bvh_stats(tb) == jdbg.bvh_stats(jb)
    if kind == "cluster":
        assert tdbg.bvh_stats(tb)["num_treelets"] > 1
    for axes, max_depth in (((0, 1), None), ((2, 0), 3)):
        np.testing.assert_array_equal(
            tdbg.bvh_outline_image(tb, 64, axes, max_depth),
            jdbg.bvh_outline_image(jb, 64, axes, max_depth))


def test_dump_bvh_writes_the_outline(trees, tmp_path):
    jb, tb = trees["lbvh"]
    stats = tdbg.dump_bvh(tb, str(tmp_path / "t.png"), width=48)
    ref = jdbg.dump_bvh(jb, str(tmp_path / "j.png"), width=48)
    assert stats.pop("path") == str(tmp_path / "t.png")
    assert stats == ref
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


def test_bounce_histogram_matches_jax():
    js, jcam = j_cornell()
    ts, _ = t_cornell(device=CPU)
    n = 12
    x, y = j_pixel_grid(n, n)
    # jittered off the pixel centres: rays through the centres graze the
    # box's triangle edges, where JAX's and the port's brute-force tests
    # round apart (2 of 144 lanes)
    jitter = np.random.default_rng(5).uniform(-0.4, 0.4, (n * n, 2))
    jray = jcam.primary_rays(x, y, n, n, jnp.asarray(jitter, jnp.float32))
    pid = np.arange(n * n, dtype=np.uint32)
    jcounts = jmetrics.bounce_histogram(
        JParams.create(js, num_bounces=4, epsilon=1e-3), jray,
        JSampler.seed(0, jnp.asarray(pid), jnp.uint32(1)))
    tcounts = tmetrics.bounce_histogram(
        KernelParams.create(ts, num_bounces=4, epsilon=1e-3),
        Ray(ori=torch.as_tensor(np.array(jray.ori)),
            dir=torch.as_tensor(np.array(jray.dir))),
        Sampler.seed(0, torch.as_tensor(pid.astype(np.int64)), 1))
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert tcounts[0] == n * n and tcounts[-1] < tcounts[0]


def test_metrics_helpers_match_jax(tmp_path):
    for algo in ("simple", "pathtracing"):
        assert tmetrics.frame_metrics(64, 32, 2, 5, 0.25, 1000, algo, 2) \
            == jmetrics.frame_metrics(64, 32, 2, 5, 0.25, 1000, algo, 2)
    table = {1: 10.0, 2: 19.0, 4: 36.0}
    assert tmetrics.scaling_efficiency(table) == \
        jmetrics.scaling_efficiency(table)
    log = tmetrics.MetricsLog(str(tmp_path / "m.jsonl"))
    log.emit({"a": 1})
    log.emit({"b": 2.5})
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(s) for s in lines] == log.records
    timer = tmetrics.Timer()
    assert timer.elapsed(torch.zeros(3)) >= 0.0
    counter = tmetrics.FrameCounter(window=10.0)
    assert counter.register_frame() == 0.0
    time.sleep(0.01)
    assert counter.register_frame() > 0.0
    assert tmetrics.memory_stats("cpu") == {}


def _same_leaves(a, b):
    la, lb = tck._leaves(a), tck._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    rt = RenderTarget(color=torch.as_tensor(rng.uniform(
        0, 1, (4, 5, 4)).astype(np.float32)), depth=torch.ones(4, 5),
        width=5, height=4)
    tck.RenderCheckpoint.save(str(tmp_path / "rt.npz"), rt, 7, seed=3)
    back, frame, seed = tck.RenderCheckpoint.load(
        str(tmp_path / "rt.npz"),
        RenderTarget(torch.zeros(4, 5, 4), torch.zeros(4, 5), 5, 4))
    _same_leaves(back, rt)
    assert (frame, seed, back.width) == (7, 3, 5)
    typed = make_typed_render_target(5, 4, "RGBA8", device=CPU)
    typed = dataclasses.replace(typed, color=torch.full_like(typed.color,
                                                             9))
    tck.save_pytree(str(tmp_path / "typed.npz"), typed)
    back, meta = tck.load_pytree(str(tmp_path / "typed.npz"),
                                 make_typed_render_target(5, 4, "RGBA8",
                                                          device=CPU))
    assert meta is None and back.color.dtype == torch.uint8
    _same_leaves(back, typed)
    tree = {"b": (torch.arange(3), None, 2.5), "a": [torch.eye(2)]}
    tck.save_pytree(str(tmp_path / "tree"), tree, {"note": "x"})
    back, meta = tck.load_pytree(str(tmp_path / "tree"), tree)
    assert meta == {"note": "x"} and back["b"][2] == 2.5
    _same_leaves(back, tree)
    with pytest.raises(ValueError, match="leaves"):
        tck.load_pytree(str(tmp_path / "tree.npz"), (torch.eye(2),))
    with pytest.raises(ValueError, match="render"):
        tck.RenderCheckpoint.load(str(tmp_path / "tree.npz"), tree)


def test_render_checkpoints_cross_load(tmp_path):
    rng = np.random.default_rng(1)
    color = rng.uniform(0, 1, (3, 6, 4)).astype(np.float32)
    depth = rng.uniform(0, 9, (3, 6)).astype(np.float32)
    jck.RenderCheckpoint.save(str(tmp_path / "j.npz"), JRenderTarget(
        color=jnp.asarray(color), depth=jnp.asarray(depth), width=6,
        height=3), 5, seed=2)
    like = RenderTarget(torch.zeros(3, 6, 4), torch.zeros(3, 6), 6, 3)
    rt, frame, seed = tck.RenderCheckpoint.load(str(tmp_path / "j.npz"),
                                                like)
    np.testing.assert_array_equal(rt.color.numpy(), color)
    np.testing.assert_array_equal(rt.depth.numpy(), depth)
    assert (frame, seed) == (5, 2)
    tck.RenderCheckpoint.save(str(tmp_path / "t.npz"), rt, 6, seed=4)
    jrt, jframe, jseed = jck.RenderCheckpoint.load(
        str(tmp_path / "t.npz"), JRenderTarget.create(6, 3))
    np.testing.assert_array_equal(np.asarray(jrt.color), color)
    np.testing.assert_array_equal(np.asarray(jrt.depth), depth)
    assert (jframe, jseed) == (6, 4)


def test_optim_checkpoint_round_trips(tmp_path):
    params = {"cd": torch.full((3, 3), 0.5, requires_grad=True),
              "verts": torch.zeros(4, 3, requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=0.01)
    (params["cd"].sum() * 2 + params["verts"].square().sum()).backward()
    opt.step()
    tck.OptimCheckpoint.save(str(tmp_path / "o.npz"),
                             {k: v.detach() for k, v in params.items()},
                             opt.state_dict(), step=1)
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, state, step = tck.OptimCheckpoint.load(
        str(tmp_path / "o.npz"), fresh, opt.state_dict())
    assert step == 1
    for k in params:
        assert torch.equal(p2[k], params[k].detach())
    opt2 = torch.optim.Adam([torch.zeros(3, 3, requires_grad=True),
                             torch.zeros(4, 3, requires_grad=True)],
                            lr=0.5)
    opt2.load_state_dict(state)
    assert opt2.param_groups[0]["lr"] == 0.01
    for i in (0, 1):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt2.state_dict()["state"][i][k],
                               opt.state_dict()["state"][i][k])


def test_cache_names_the_build_directory(tmp_path, monkeypatch):
    import visionaray_torch.ops.sah as sah
    import visionaray_torch.ops.traverse as trav
    monkeypatch.setattr(trav, "_BUILD_ROOT", trav._BUILD_ROOT)
    monkeypatch.setattr(sah, "_BUILD_ROOT", sah._BUILD_ROOT)
    assert tcache.enable_compilation_cache() == str(tcache.DEFAULT)
    assert trav._BUILD_ROOT == tcache.DEFAULT
    assert tcache.DEFAULT.parts[-2:] == ("build", "visionaray_torch")
    got = tcache.enable_compilation_cache(str(tmp_path / "kernels"))
    assert got == str(tmp_path / "kernels")
    assert trav._BUILD_ROOT == tmp_path / "kernels"
    assert sah._BUILD_ROOT == tmp_path / "kernels" / "sah"
