"""The program on one card: a triangle scene on its LBVH, path traced with
next-event estimation.

- ``train`` mixes: ``sched/step.py::loss_and_grads`` back to back (loss
  and gradients to the vertices and the diffuse colours of one frame in
  tiles of ``tile`` lanes), the loss read on the host after every step;
- ``frame`` mixes: ``sched/render.py::render_pixels(..., "pathtracing",
  nee=True)`` over every pixel, under the inference mode it picks itself.

Frame numbers run from a base drawn from the seed, one a step or frame.
With ``--trace 1`` the training step is run as its two calls,
``frame_loss`` and ``torch.autograd.grad``, each ended by a synchronize
and timed (the spans ``forward_s`` and ``backward_s``), and a few more
iterations run under the profiler.
"""

from __future__ import annotations

import math
import sys
import time


def run(r):
    import torch

    from harness import pixels, program, spec
    from harness import trace as tracing
    from harness import window as win
    from visionaray_torch.sched import render as vrender
    from visionaray_torch.sched import step

    dev = torch.device(r.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t = r.traffic
    marks = [("start", time.time() - r.t_start_wall)]
    if cuda:
        program.build_library()
        marks.append(("library", time.time() - r.t_start_wall))
    gen = spec.scene_module(r.config["scene"]["generator"])
    verts, faces, gids, cam = gen.build(r.config["scene"], r.seed)
    marks.append(("arrays", time.time() - r.t_start_wall))
    scene = program.scene(r.config, verts, faces, gids, dev)
    sync()
    marks.append(("scene_and_tree", time.time() - r.t_start_wall))
    pcam = program.camera(cam, dev)
    params = program.kernel_params(r.config, t, scene)
    W, H, spp, nee = t["width"], t["height"], t["spp"], t["nee"]
    x, y = pixels.order(t["pixel_order"], W, H)
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    frame0 = win.first_frame(r.seed, t["warm"])
    kept = {}
    failed = [0]
    spans = dict(forward_s=0.0, backward_s=0.0)

    def keep(i, item):
        if i == 0:
            kept["first"] = item
        if i >= 0:
            kept["last"] = item

    if t["kind"] == "train":
        v0, cd0 = scene.mesh.vertices, scene.materials.cd
        kw = dict(width=W, height=H, spp=spp, tile=t["tile"])

        def iteration(i):
            loss, (gv, gc) = step.loss_and_grads(v0, cd0, frame0 + i, params,
                                                 pcam, xt, yt, nee=nee, **kw)
            value = float(loss)          # the trainer reads its loss
            failed[0] += not math.isfinite(value)
            keep(i, (frame0 + i, value, gv, gc))

        def spanned(i):
            with torch.enable_grad():
                v = v0.detach().requires_grad_()
                c = cd0.detach().requires_grad_()
                t0 = time.perf_counter()
                loss = step.frame_loss(v, c, frame0 + i, params, pcam, xt,
                                       yt, nee, **kw)
                sync()
                t1 = time.perf_counter()
                gv, gc = torch.autograd.grad(loss, (v, c))
                sync()
                t2 = time.perf_counter()
            spans["forward_s"] += t1 - t0
            spans["backward_s"] += t2 - t1
            value = float(loss.detach())
            failed[0] += not math.isfinite(value)
            keep(i, (frame0 + i, value, gv, gc))
    elif t["kind"] == "frame":
        def iteration(i):
            color, _ = vrender.render_pixels(
                params, pcam, xt, yt, W, H, "pathtracing", spp,
                "jittered_blend", frame0 + i, nee=nee)
            keep(i, (frame0 + i, color))
        spanned = iteration
    else:
        raise ValueError(f"traffic kind {t['kind']!r}: train or frame")

    for j in range(t["warm"]):
        iteration(-1 - j)
        sync()
        marks.append((f"warm{j}", time.time() - r.t_start_wall))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    program.reset_counters()
    setup_s = time.time() - r.t_start_wall
    print("setup (s since process start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks), file=sys.stderr, flush=True)
    w = win.measure(spanned if r.trace else iteration, r.seconds, sync)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = program.counters()
    summary = None
    if r.trace:
        k0, k = w.count, t["trace_iterations"]

        def traced():
            for j in range(k):
                iteration(k0 + j)
            sync()
        summary = tracing.profile(traced)
    peak = max(peak, torch.cuda.max_memory_allocated() if cuda else 0)

    items = [kept["first"], kept["last"]]
    if t["kind"] == "frame":
        lanes = pixels.sample(x.shape[0], t["check_pixels"], r.seed)
        li = torch.as_tensor(lanes, device=dev)
        out = dict(kind="frame", lanes=lanes,
                   items=[(f, c[li].float().cpu().numpy()) for f, c in items])
    else:
        out = dict(kind="train",
                   items=[(f, lv, gv.double().cpu().numpy(),
                           gc.double().cpu().numpy())
                          for f, lv, gv, gc in items])
    return dict(rate="step_s" if t["kind"] == "train" else "frame_s",
                setup_s=setup_s, window=w, attempted=w.count,
                failed=failed[0], peak_window_bytes=window_peak,
                memory_peak_bytes=peak, traces=[summary] if r.trace else [],
                spans=spans, counters=[counters], kept=out,
                shapes=dict(triangles=int(faces.shape[0]), width=W, height=H,
                            spp=spp, bounces=t["bounces"],
                            traced_iterations=t.get("trace_iterations", 0)))
