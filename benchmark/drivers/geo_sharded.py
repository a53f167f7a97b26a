"""The program on several cards: a triangle scene split into spatial
shards, one a rank, each with its own tree, and the frame through
``parallel/sharded_pt.py::render_image_geometry_sharded`` (each rank path
traces its block of rows; rays ride the ring of hops over the shards;
the blocks are gathered on every rank).

The parent process builds the kernels' library, starts one rank process
a card (``run.py --rank-worker DIR``) and waits.  Each rank takes its
card, makes the whole scene from the seed, keeps its own shard, warms
the frame and measures; rank 0 decides with the others, after every
frame, whether the window has closed.  A frame is done when every rank's
block is done (the gather ends it), timed on rank 0.  Rank 0 keeps the
sampled pixels of the window's first and last frames for the check,
which the parent runs once every rank has ended.  Each rank writes, at
its end, the forbidden modules it holds (``harness/modules.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

RANK_TIMEOUT = 330.0


def run(r):
    from harness import program, ranks

    world = int(r.config["shards"])
    if r.device == "cuda":
        program.build_library()
    out = tempfile.mkdtemp(prefix="bench_ranks_")
    try:
        write_run(r, out)
        argv = [sys.executable, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "run.py"),
            "--workload", r.cell["name"], "--seed", str(r.seed),
            "--seconds", repr(r.seconds), "--trace", str(int(r.trace)),
            "--rank-worker", out]
        left = RANK_TIMEOUT - (time.time() - r.t_start_wall)
        codes = ranks.spawn(world, argv, out, left)
        if any(c != 0 for c in codes):
            for k, c in enumerate(codes):
                print(f"rank {k} exited {c}:\n{ranks.log_tail(out, k)}",
                      file=sys.stderr)
            raise RuntimeError(f"rank exit codes {codes}")
        return collect(r, out, world)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def write_run(r, out: str):
    """What every rank reads in place of the files: the run's
    configuration, mix and device as the parent holds them."""
    with open(os.path.join(out, "run.json"), "w") as f:
        json.dump(dict(config=r.config, traffic=r.traffic,
                       device=r.device), f)


def collect(r, out: str, world: int) -> dict:
    """The run's record from the ranks' files."""
    from harness.window import Window
    res = []
    for k in range(world):
        with open(os.path.join(out, f"rank{k}.json")) as f:
            res.append(json.load(f))
    kept = np.load(os.path.join(out, "kept.npz"))
    r0 = res[0]
    w = Window(start=r0["start"], end=r0["end"],
               start_wall=r0["start_wall"], times=r0["times"],
               cpu_s=r0["cpu_s"], preempted=r0["preempted"])
    frames = [int(f) for f in kept["frames"]]
    return dict(
        rate="sharded_frame_s",
        setup_s=r0["start_wall"] - r.t_start_wall, window=w,
        attempted=w.count, failed=0,
        peak_window_bytes=max(x["peak_window_bytes"] for x in res),
        memory_peak_bytes=max(x["memory_peak_bytes"] for x in res),
        traces=[x["trace"] for x in res] if r.trace else [],
        spans={}, counters=[x["counters"] for x in res],
        forbidden=sorted({m for x in res for m in x["forbidden"]}),
        kept=dict(kind="frame", lanes=kept["lanes"],
                  items=[(frames[0], kept["first"]),
                         (frames[1], kept["last"])]),
        shapes=dict(triangles=int(r0["triangles"]),
                    width=r.traffic["width"], height=r.traffic["height"],
                    spp=r.traffic["spp"], bounces=r.traffic["bounces"],
                    traced_iterations=r.traffic.get("trace_iterations", 0),
                    ranks=world))


def rank_main(r, out: str) -> int:
    import torch
    import torch.distributed as dist

    from harness import pixels, program, spec
    from harness import trace as tracing
    from harness import window as win
    from harness.modules import forbidden_modules
    from visionaray_torch.parallel import multihost, ring
    from visionaray_torch.parallel.sharded_pt import (
        render_image_geometry_sharded,
    )
    from visionaray_torch.parallel.tile_sharding import make_mesh

    with open(os.path.join(out, "run.json")) as f:
        given = json.load(f)
    r.config, r.traffic, r.device = (given["config"], given["traffic"],
                                     given["device"])
    cuda = r.device == "cuda"
    multihost.initialize(device=r.device)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
            else torch.device("cpu")

        def sync():
            if cuda:
                torch.cuda.synchronize()

        if cuda:
            program.build_library()     # built by the parent: loaded here
        c, t = r.config, r.traffic
        mesh = make_mesh()
        gen = spec.scene_module(c["scene"]["generator"])
        verts, faces, gids, cam = gen.build(c["scene"], r.seed)
        n_tris = int(faces.shape[0])
        whole = program.mesh(verts, faces, gids, dev)
        geo = ring.shard_geometry(whole, world, backend=c["backend"],
                                  with_shading=True, shards=(rank,))
        del whole, verts
        if cuda:
            torch.cuda.empty_cache()
        mats = program.materials(c, dev)
        lights = program.lights(c, dev)
        pcam = program.camera(cam, dev)
        rd = c["render"]
        W, H = t["width"], t["height"]
        frame0 = win.first_frame(r.seed, t["warm"])
        kept = {}

        def iteration(i):
            color, _ = render_image_geometry_sharded(
                geo, mats, lights, pcam, W, H, mesh,
                num_bounces=t["bounces"], spp=t["spp"], eps=rd["epsilon"],
                bg_color=tuple(rd["bg_color"]),
                ambient=tuple(rd["ambient"][:3]), frame_num=frame0 + i,
                nee=t["nee"])
            if i == 0:
                kept["first"] = (frame0 + i, color)
            if i >= 0:
                kept["last"] = (frame0 + i, color)

        flag = torch.zeros(1, dtype=torch.int32, device=dev)

        def stop(done: bool) -> bool:
            # rank 0's clock closes the window for every rank
            flag.fill_(int(done) if rank == 0 else 0)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            return bool(flag.item())

        with torch.no_grad():
            for j in range(t["warm"]):
                iteration(-1 - j)
            sync()
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            dist.barrier()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            program.reset_counters()
            w = win.measure(iteration, r.seconds, sync, stop)
            window_peak = torch.cuda.max_memory_allocated() if cuda else 0
            counters = program.counters()
            summary = None
            if r.trace:
                k0, k = w.count, t["trace_iterations"]

                def traced():
                    for j in range(k):
                        iteration(k0 + j)
                    sync()
                summary = tracing.profile(traced, dist.barrier)
            peak = max(peak, torch.cuda.max_memory_allocated() if cuda else 0)
            if rank == 0:
                lanes = pixels.sample(W * H, t["check_pixels"], r.seed)
                li = torch.as_tensor(lanes, device=dev)

                def sample(img):
                    return img.reshape(-1, 4)[li].float().cpu().numpy()
                np.savez(os.path.join(out, "kept.npz"), lanes=lanes,
                         frames=np.array([kept["first"][0],
                                          kept["last"][0]]),
                         first=sample(kept["first"][1]),
                         last=sample(kept["last"][1]))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(dict(start=w.start, end=w.end, start_wall=w.start_wall,
                           times=w.times, cpu_s=w.cpu_s,
                           preempted=w.preempted,
                           peak_window_bytes=window_peak,
                           memory_peak_bytes=peak, counters=counters,
                           trace=summary, triangles=n_tris,
                           forbidden=forbidden_modules()), f)
        return 0
    finally:
        multihost.shutdown()
