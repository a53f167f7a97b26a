"""The program's own tracing (visionaray_torch/utils/metrics.py) on the CPU:

- off (the default), ``span`` is one shared no-op and ``count`` returns at
  once: a path-traced frame runs with the clock and CUDA events made to
  raise, and leaves nothing recorded;
- on, a 5-bounce NEE frame's spans come out bounce by bounce and tile
  it (closest, shade, nee, shade); a training step adds ``step.forward``
  and ``step.backward``, and the bounces' recompute (``recompute=True``)
  opens only inside ``step.backward`` and counts nothing;
- the spans' clock is the profiler's: a span around a ``record_function``
  range brackets it on the profiler's timeline;
- ``bounce.live`` of the Cornell box without NEE equals the JAX package's
  ``bounce_histogram`` with the same rays and sampler; primary rays are
  all live at bounce 0;
- counters by index and without one, and ``reset``; ``recomputing``
  marks its spans and counts nothing;
- on two gloo ranks of a geometry-sharded frame, one ``ring.hop`` span a
  counted hop and two ``ring.pack`` spans around each.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.ops.sampling import Sampler as JSampler
from visionaray_tpu.scenes import cornell_box as j_cornell
from visionaray_tpu.sched.render import _pixel_grid as j_pixel_grid
from visionaray_tpu.utils import metrics as jmetrics

from visionaray_torch.core.types import Ray
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.kernels.pathtracing import pathtracing_kernel
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.scenes import cornell_box as t_cornell
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render, step
from visionaray_torch.utils import metrics

from test_torch_multihost import run_ranks

torch.set_num_threads(1)
CPU = "cpu"
W = H = 8
BOUNCES = 5
PHASES = ["bounce.closest", "bounce.shade", "bounce.nee", "bounce.shade"]


@pytest.fixture(autouse=True)
def tracing_off():
    metrics.enable(False)
    metrics.reset()
    yield
    metrics.enable(False)
    metrics.reset()


@pytest.fixture(scope="module")
def sponza():
    scene, cam = sponza_like_scene(target_tris=600, device=CPU)
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    params = KernelParams.create(scene, num_bounces=BOUNCES, epsilon=1e-3)
    return params, cam, x.reshape(-1), y.reshape(-1)


def _frame(sponza):
    params, cam, x, y = sponza
    color, _ = render.render_pixels(params, cam, x, y, W, H, "pathtracing",
                                    1, "jittered_blend", 1, nee=True)
    return color


def _step(sponza):
    params, cam, x, y = sponza
    return step.loss_and_grads(params.scene.mesh.vertices,
                               params.scene.materials.cd, 1, params, cam, x,
                               y, nee=True, width=W, height=H, tile=64)


def _raise(*a, **k):
    raise AssertionError("tracing off touched the clock or made an event")


def test_off_reads_no_clock_and_makes_no_event(sponza, monkeypatch):
    assert metrics.span("bounce.closest", bounce=0) is metrics.NO_SPAN
    assert metrics.span("x") is metrics.span("y")
    on = _frame(sponza)
    monkeypatch.setattr(time, "time_ns", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    with metrics.span("outer", a=1) as s:
        assert s is metrics.NO_SPAN
        metrics.count("c", torch.ones(3))
        off = _frame(sponza)
    monkeypatch.undo()
    torch.testing.assert_close(off, on, rtol=0, atol=0)
    snap = metrics.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def _tiles(spans):
    """Each span ends no later than the next one starts."""
    for a, b in zip(spans, spans[1:]):
        assert a["host_ns"][0] <= a["host_ns"][1] <= b["host_ns"][0]


def test_frame_spans_tile_each_bounce(sponza):
    metrics.enable(True)
    _frame(sponza)
    snap = metrics.snapshot()
    spans = snap["spans"]
    assert [(s["name"], s["tags"]) for s in spans] == \
        [(p, {"bounce": b}) for b in range(BOUNCES) for p in PHASES]
    _tiles(spans)
    assert all(s["stream_ms"] is None for s in spans)     # no CUDA here
    c = snap["counters"]
    assert c["bounce.lanes"] == [W * H] * BOUNCES
    assert all(0 < s <= v for s, v in zip(c["bounce.shadow"],
                                          c["bounce.live"]))


def test_step_spans_and_recompute(sponza):
    metrics.enable(True)
    loss, _ = _step(sponza)
    snap = metrics.snapshot()
    spans = snap["spans"]
    names = [s["name"] for s in spans]
    assert names.count("step.forward") == names.count("step.backward") == 1
    fwd, bwd = (spans[names.index(n)]["host_ns"]
                for n in ("step.forward", "step.backward"))
    assert fwd[1] <= bwd[0]
    bounces = [s for s in spans if s["name"].startswith("bounce.")]
    forward = [s for s in bounces if "recompute" not in s["tags"]]
    again = [s for s in bounces if s["tags"].get("recompute")]
    assert [(s["name"], s["tags"]) for s in forward] == \
        [(p, {"bounce": b}) for b in range(BOUNCES) for p in PHASES]
    # the backward replays the bounces last to first, each in full
    assert [(s["name"], s["tags"]["bounce"]) for s in again] == \
        [(p, b) for b in reversed(range(BOUNCES)) for p in PHASES]
    for s in forward:
        assert fwd[0] <= s["host_ns"][0] and s["host_ns"][1] <= fwd[1]
    for s in again:
        assert bwd[0] <= s["host_ns"][0] and s["host_ns"][1] <= bwd[1]
    # the counters saw the forward bounces only: those of a frame
    metrics.reset()
    _frame(sponza)
    assert snap["counters"] == metrics.snapshot()["counters"]
    assert np.isfinite(float(loss))


def test_spans_share_the_profilers_clock():
    metrics.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with metrics.span("outer", i=i):
                with record_function(f"probe{i}"):
                    torch.ones(10_000).sum()
    spans = metrics.snapshot()["spans"]
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    lead, trail = [], []
    for i, s in enumerate(spans):
        r = events[f"probe{i}"].time_range
        r0, r1 = start + r.start * 1e3, start + r.end * 1e3
        s0, s1 = s["host_ns"]
        assert start <= s0 <= r0 <= r1 <= s1
        lead.append(r0 - s0)
        trail.append(s1 - r1)
    # the first ranges pay the profiler's own set-up
    assert min(lead) < 100e3 and min(trail) < 100e3


def test_live_lanes_equal_jax_bounce_histogram():
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
    metrics.enable(True)
    pathtracing_kernel(
        KernelParams.create(ts, num_bounces=4, epsilon=1e-3),
        Ray(ori=torch.as_tensor(np.array(jray.ori)),
            dir=torch.as_tensor(np.array(jray.dir))),
        Sampler.seed(0, torch.as_tensor(pid.astype(np.int64)), 1),
        nee=False)
    snap = metrics.snapshot()
    # without NEE a bounce is its closest span and two shade spans
    assert [(s["name"], s["tags"]) for s in snap["spans"]] == \
        [(p, {"bounce": b}) for b in range(4)
         for p in ("bounce.closest", "bounce.shade", "bounce.shade")]
    c = snap["counters"]
    assert c["bounce.live"] == np.asarray(jcounts).tolist()
    assert c["bounce.live"][-1] < c["bounce.live"][0] == n * n
    assert "bounce.shadow" not in c


def test_primary_rays_are_all_live(sponza):
    metrics.enable(True)
    _frame(sponza)
    c = metrics.snapshot()["counters"]
    assert c["bounce.live"][0] == c["bounce.lanes"][0] == W * H
    assert c["bounce.live"][-1] <= c["bounce.live"][0]


def test_counters_by_index_and_reset():
    metrics.enable(True)
    metrics.count("a", 3)
    metrics.count("a", torch.tensor([True, False, True]))
    metrics.count("b", torch.tensor([2, 5]), 2)
    metrics.count("b", 1, 0)
    metrics.count("b", torch.tensor(4), 2)
    snap = metrics.snapshot()
    assert snap == {"spans": [], "counters": {"a": 5, "b": [1, 0, 11]}}
    metrics.reset()
    assert metrics.snapshot() == {"spans": [], "counters": {}}
    metrics.enable(False)
    metrics.count("a", 1)
    assert metrics.snapshot()["counters"] == {}


def test_recomputing_marks_spans_and_counts_nothing():
    metrics.enable(True)
    with metrics.recomputing():
        with metrics.recomputing():
            pass
        with metrics.span("inner", bounce=2):
            metrics.count("c", 1)
    with metrics.span("after"):
        metrics.count("c", 2)
    snap = metrics.snapshot()
    assert [(s["name"], s["tags"]) for s in snap["spans"]] == \
        [("inner", {"bounce": 2, "recompute": True}), ("after", {})]
    assert snap["counters"] == {"c": 2}


_RING_BODY = """
from visionaray_torch.parallel import comm, ring
from visionaray_torch.parallel.sharded_pt import (
    render_image_geometry_sharded)
from visionaray_torch.parallel.tile_sharding import make_mesh
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.utils import metrics

scene, cam = sponza_like_scene(target_tris=300, device="cpu")
geo = ring.shard_geometry(scene.mesh, WORLD, backend="lbvh",
                          with_shading=True, shards=(RANK,))
mesh = make_mesh()
metrics.enable(True)
metrics.reset()
comm.reset_stats()
with torch.no_grad():
    render_image_geometry_sharded(geo, scene.materials, scene.lights, cam,
                                  8, 8, mesh, num_bounces=2, nee=True)
snap = metrics.snapshot()
names = [s["name"] for s in snap["spans"]]
OUT["hops"] = comm.STATS["hops"]
OUT["hop_spans"] = names.count("ring.hop")
OUT["pack_spans"] = names.count("ring.pack")
OUT["forward"] = all(s["tags"] == {"direction": "forward"}
                     for s in snap["spans"] if s["name"] == "ring.hop")
OUT["live0"] = snap["counters"]["bounce.live"][0]
"""


def test_ring_hop_spans_match_the_hop_count(tmp_path):
    outs = run_ranks(tmp_path, 2, _RING_BODY, {"x": np.zeros(1)})
    for o in outs:
        assert int(o["hops"]) == int(o["hop_spans"]) > 0
        assert int(o["pack_spans"]) == 2 * int(o["hops"])
        assert bool(o["forward"])
        assert int(o["live0"]) == 8 * 8 // 2
