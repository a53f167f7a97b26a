"""TraceConfig, the port's counterpart of the JAX package's traversal
switches, vs the JAX package under the same switches on the CPU.

The 16x16, 3-bounce NEE frame (render_pixels, sponza_like(4000), K=8, T=16
treelet build, frame 1) under a non-default TraceConfig against JAX's
render_pixels (Pallas kernel in interpret mode) under the same switches,
with the image tolerance of test_torch_pathtracing.py: mean abs <= 1e-4,
at most 2% of pixels off by more than 1e-3.  A spy on cluster_traverse
checks which modes each configuration launches.  This file:
shadow_binned=False (VSNRAY_SHADOW_BINNED=0) and shadow_reversed=False
(VSNRAY_SHADOW_REVERSED=0).  test_torch_trace_config_binned.py runs
shadow_m=6 with dir_bits=3, and test_torch_trace_config_grad.py the
training step under fanout=4, half_skip=True.

The JAX switches are module globals (and VSNRAY_SHADOW_M an environment
variable) read at trace time; each test patches them and clears JAX's
caches before and after.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.kernels import pathtracing as jpt
from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.ops.pallas import traverse as jtrav
from visionaray_tpu.ops.pallas.cluster_bvh import build_cluster_bvh as jbuild
from visionaray_tpu.scenes import sponza_like_scene as j_sponza
from visionaray_tpu.sched import render as jrender

from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.trace import TraceConfig
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched import render as trender

torch.set_num_threads(1)
CPU = "cpu"
W = H = 16
KW = dict(num_bounces=3, epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
          ambient_color=(1.0, 1.0, 1.0, 1.0))


def _jax_switches(monkeypatch, cfg: TraceConfig):
    """Set the JAX package's switches to ``cfg``."""
    jax.clear_caches()
    monkeypatch.setattr(jtrav, "_FANOUT_ENV",
                        "" if cfg.fanout == 2 else str(cfg.fanout))
    monkeypatch.setattr(jtrav, "_HALFSKIP_ENV", cfg.half_skip)
    monkeypatch.setattr(jtrav, "_DIR_BITS", cfg.dir_bits)
    monkeypatch.setenv("VSNRAY_SHADOW_M", str(cfg.shadow_m))
    monkeypatch.setattr(jpt, "_SHADOW_BINNED", cfg.shadow_binned)
    monkeypatch.setattr(jpt, "_SHADOW_REVERSED", cfg.shadow_reversed)


def _scenes(K, T):
    js, jcam = j_sponza(target_tris=4000, build_bvh=False)
    js = dataclasses.replace(js, bvh=jax.jit(
        jbuild, static_argnames=("cluster_size", "treelet_size"))(
            js.mesh, cluster_size=K, treelet_size=T))
    ts, tcam = sponza_like_scene(target_tris=4000, build_bvh=False,
                                 device=CPU)
    ts.bvh = build_cluster_bvh(ts.mesh, cluster_size=K, treelet_size=T)
    return js, jcam, ts, tcam


def _image_close(got, ref):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.reshape(-1, diff.shape[-1]).max(-1) > 1e-3).mean() <= 0.02


CONFIGS = {
    "shadow_coherent": (TraceConfig(shadow_binned=False),
                        {"closest", "any", "binned_closest"}),
    "shadow_from_surface": (TraceConfig(shadow_reversed=False),
                            {"closest", "any", "binned_closest",
                             "binned_any"}),
}


def check_frame(cfg, modes, monkeypatch):
    """The frame under ``cfg`` on both sides; the port launches ``modes``."""
    js, jcam, ts, tcam = _scenes(8, 16)
    _jax_switches(monkeypatch, cfg)
    try:
        x, y = jrender._pixel_grid(W, H)
        jcol, jdepth = jrender.render_pixels(
            JParams.create(js, **KW), jcam, x, y, W, H, "pathtracing", 1,
            "jittered_blend", jnp.uint32(1), nee=True)
        jcol, jdepth = np.asarray(jcol), np.asarray(jdepth)
    finally:
        jax.clear_caches()
    seen = []
    real = trav.cluster_traverse

    def spy(*a, **k):
        seen.append(("binned_" if k.get("tile_roots") is not None else "")
                    + ("any" if k.get("any_hit") else "closest"))
        return real(*a, **k)

    monkeypatch.setattr(trav, "cluster_traverse", spy)
    tx, ty = trender._pixel_grid(W, H, CPU)
    col, depth = trender.render_pixels(
        KernelParams.create(ts, trace=cfg, **KW), tcam, tx, ty, W, H,
        "pathtracing", 1, "jittered_blend", 1, nee=True)
    assert set(seen) == modes
    assert float(col[:, :3].std()) > 0
    _image_close(col.numpy(), jcol)
    np.testing.assert_allclose(depth.numpy(), jdepth, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_matches_jax_under_switch(name, monkeypatch):
    check_frame(*CONFIGS[name], monkeypatch)
