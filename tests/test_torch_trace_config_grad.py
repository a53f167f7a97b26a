"""The training step under TraceConfig(fanout=4, half_skip=True) vs the JAX
package under VSNRAY_FANOUT=4, VSNRAY_HALFSKIP=1 on the CPU.

loss_and_grads on sponza_like(4000) with a K=16, T=16 treelet build (C=512,
half boxes), 16x16 pixels in 8-px blocks, 3 bounces, NEE, frame 1, in tiles
of 160 lanes, against jax.value_and_grad of bench.py's loss with the Pallas
kernel in interpret mode.  Tolerance of test_torch_grad.py: loss rtol 1e-5,
relative L2 error <= 1e-3 and cosine >= 0.999 for both gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_trace_config import KW, W, H, _jax_switches, _scenes

from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.sched import render as jrender

from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops.trace import TraceConfig
from visionaray_torch.sched import step

torch.set_num_threads(1)
TILE = 160


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _cosine(got, ref):
    return float((got * ref).sum()
                 / (np.linalg.norm(got) * np.linalg.norm(ref)))


def test_loss_and_grads_fanout4_half_skip_match_jax(monkeypatch):
    cfg = TraceConfig(fanout=4, half_skip=True)
    js, jcam, ts, tcam = _scenes(16, 16)
    assert ts.bvh.half_boxes and js.bvh.half_boxes
    # a 16x16 frame in 8-px blocks (bench.py's swizzle at this size)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    order = np.argsort(((yy // 8) * (W // 8) + (xx // 8)).reshape(-1),
                       kind="stable")
    x = xx.reshape(-1)[order].astype(np.int32)
    y = yy.reshape(-1)[order].astype(np.int32)
    n = x.shape[0]
    n_tiles = -(-n // TILE)
    pad = n_tiles * TILE - n
    xt = jnp.asarray(np.concatenate([x, np.zeros(pad, np.int32)])
                     ).reshape(n_tiles, TILE)
    yt = jnp.asarray(np.concatenate([y, np.zeros(pad, np.int32)])
                     ).reshape(n_tiles, TILE)
    p = JParams.create(js, **KW)

    def loss_fn(verts, cd):   # bench.py:123-137 at this size
        p2 = dataclasses.replace(p, scene=dataclasses.replace(
            p.scene, mesh=dataclasses.replace(p.scene.mesh, vertices=verts),
            materials=dataclasses.replace(p.scene.materials, cd=cd)))

        def tile_fn(args):
            color, _ = jrender.render_pixels(
                p2, jcam, args[0], args[1], W, H, "pathtracing", 1,
                "jittered_blend", jnp.uint32(1), nee=True)
            return jnp.sum(color[..., :3])

        return jnp.sum(jax.lax.map(tile_fn, (xt, yt))) / (n * 3)

    _jax_switches(monkeypatch, cfg)
    try:
        jloss, (jgv, jgc) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1)))(js.mesh.vertices, js.materials.cd)
        jloss, jgv, jgc = float(jloss), np.asarray(jgv), np.asarray(jgc)
    finally:
        jax.clear_caches()

    params = KernelParams.create(ts, trace=cfg, **KW)
    loss, (gv, gc) = step.loss_and_grads(
        ts.mesh.vertices, ts.materials.cd, 1, params, tcam,
        torch.as_tensor(x), torch.as_tensor(y), nee=True, width=W, height=H,
        tile=TILE)
    gv, gc = gv.numpy(), gc.numpy()
    assert np.isfinite(gv).all() and np.isfinite(gc).all()
    assert np.abs(gv).sum() > 0 and np.abs(gc).sum() > 0
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for got, ref in ((gc, jgc), (gv, jgv)):
        assert _rel_l2(got, ref) <= 1e-3, _rel_l2(got, ref)
        assert _cosine(got, ref) >= 0.999, _cosine(got, ref)
