#!/usr/bin/env python3
"""Scan the benchmark's training mix for non-finite losses, frame by frame,
and name the operation where a non-finite value first appears.

    python3 scripts/torch_nonfinite_scan.py [--root DIR] [--seeds S,S,...]
        [--frames N] [--cell sponza_lbvh.train] [--lanes K] [--out FILE]

For each seed: the cell's scene from the seed (the benchmark's own
generator and configuration), then ``sched/step.py::frame_loss`` under
``torch.no_grad()`` for N consecutive frame numbers from the seed's base
(``benchmark/harness/window.py::first_frame``): the training step's loss
without its backward.  A frame whose loss is not finite is rendered again
to name its non-finite pixels.  For the first K of them the pixel is
rendered alone, by the fused path and by the torch body
(``kernels/pathtracing.py::_torch_body``), the latter under a dispatch
mode that records every operation whose floating output holds a
non-finite value, with its inputs and the package's lines that called it.

``--root``: the directory whose ``visionaray_torch`` is imported (default:
this checkout), so that two trees can be scanned side by side, one
process each.  The whole record goes to ``--out`` as JSON; one summary
line a seed goes to stdout.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _summary(x):
    import torch
    if not isinstance(x, torch.Tensor):
        return repr(x)[:80]
    if x.numel() <= 12:
        return dict(dtype=str(x.dtype), shape=list(x.shape),
                    value=x.detach().cpu().tolist())
    return dict(dtype=str(x.dtype), shape=list(x.shape))


def _recorder(limit: int):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class NonFinite(TorchDispatchMode):
        """Records each op whose floating output is not all finite."""

        def __init__(self):
            super().__init__()
            self.events = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if len(self.events) >= limit:
                return out
            for o in tree_flatten(out)[0]:
                if (isinstance(o, torch.Tensor) and o.is_floating_point()
                        and o.numel()
                        and not bool(torch.isfinite(o).all())):
                    stack = [f"{Path(f.filename).name}:{f.lineno} {f.name}: "
                             f"{f.line}"
                             for f in traceback.extract_stack()
                             if "visionaray_torch" in f.filename]
                    self.events.append(dict(
                        op=str(func), stack=stack[-5:],
                        inputs=[_summary(a) for a in args],
                        out=_summary(o)))
                    break
            return out

    return NonFinite()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--seeds", default="2147483659,1299709,3000000019")
    ap.add_argument("--frames", type=int, default=10000)
    ap.add_argument("--cell", default="sponza_lbvh.train")
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--events", type=int, default=60)
    ap.add_argument("--out", default="build/nonfinite_scan.json")
    ap.add_argument("--small", action="store_true",
                    help="a 32x18 frame on the CPU, to rehearse the script")
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.root).resolve()), str(ROOT / "benchmark")]

    import torch

    from harness import pixels, program, spec
    from harness import window as win
    from visionaray_torch.kernels import pathtracing
    from visionaray_torch.sched import render as vrender
    from visionaray_torch.sched import step

    if args.small:
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise SystemExit("torch_nonfinite_scan: needs a CUDA card")
    else:
        dev = torch.device("cuda")
        program.build_library()
    bench = spec.benchmark()
    cell = spec.cell(bench, args.cell)
    config = spec.config(bench, cell["config"])
    t = spec.traffic(cell["traffic"])
    W, H, spp, nee, tile = t["width"], t["height"], t["spp"], t["nee"], \
        t["tile"]
    if args.small:
        W, H, tile = 32, 18, 1024
    x, y = pixels.order(t["pixel_order"], W, H)
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    n = xt.shape[0]
    pad = -(-n // tile) * tile - n
    xp = torch.cat([xt, torch.zeros((pad,), dtype=xt.dtype, device=dev)])
    yp = torch.cat([yt, torch.zeros((pad,), dtype=yt.dtype, device=dev)])
    record = dict(root=str(Path(args.root).resolve()), cell=args.cell,
                  card=("cpu" if args.small
                        else torch.cuda.get_device_name(0)),
                  torch=torch.__version__, seeds=[])
    for seed in (int(s) for s in args.seeds.split(",")):
        gen = spec.scene_module(config["scene"]["generator"])
        verts, faces, gids, cam = gen.build(config["scene"], seed)
        scene = program.scene(config, verts, faces, gids, dev)
        pcam = program.camera(cam, dev)
        params = program.kernel_params(config, t, scene)
        v0, cd0 = scene.mesh.vertices, scene.materials.cd
        base = win.first_frame(seed, t["warm"])
        bad = []
        t0 = time.perf_counter()
        with torch.no_grad():
            for c0 in range(0, args.frames, 250):
                frames = range(base + c0, base + min(c0 + 250, args.frames))
                losses = torch.stack([step.frame_loss(
                    v0, cd0, f, params, pcam, xt, yt, nee, width=W,
                    height=H, spp=spp, tile=tile) for f in frames])
                finite = torch.isfinite(losses).cpu().tolist()
                vals = losses.cpu().tolist()
                bad += [(f, v) for f, ok, v in zip(frames, finite, vals)
                        if not ok]
        secs = time.perf_counter() - t0
        entry = dict(seed=seed, base=base, frames=args.frames,
                     last=base + args.frames - 1, seconds=secs,
                     nonfinite=[dict(frame=f, loss=str(v)) for f, v in bad])
        for item in entry["nonfinite"]:
            with torch.no_grad():
                color, depth = vrender.render_pixels(
                    params, pcam, xp, yp, W, H, "pathtracing", spp,
                    "jittered_blend", item["frame"], nee=nee)
            lanes = torch.nonzero(~torch.isfinite(color[:, :3]).all(-1))
            lanes = lanes[:, 0].cpu().tolist()
            item["lanes"] = []
            for lane in lanes[:8]:
                px, py = int(xp[lane]), int(yp[lane])
                item["lanes"].append(dict(
                    lane=lane, x=px, y=py, depth=float(depth[lane]),
                    color=color[lane].cpu().tolist()))
            item["nonfinite_lanes"] = len(lanes)
            for ln in item["lanes"][:args.lanes]:
                one_x = torch.tensor([ln["x"]], dtype=xt.dtype, device=dev)
                one_y = torch.tensor([ln["y"]], dtype=yt.dtype, device=dev)

                def one():
                    return vrender.render_pixels(
                        params, pcam, one_x, one_y, W, H, "pathtracing",
                        spp, "jittered_blend", item["frame"], nee=nee)
                with torch.no_grad():
                    ln["fused_alone"] = one()[0][0].cpu().tolist()
                    ok = pathtracing._fused_ok
                    pathtracing._fused_ok = lambda p: False
                    try:
                        rec = _recorder(args.events)
                        with rec:
                            ln["torch_body_alone"] = one()[0][0].cpu(
                                ).tolist()
                    finally:
                        pathtracing._fused_ok = ok
                ln["events"] = rec.events
        record["seeds"].append(entry)
        print(json.dumps(dict(
            seed=seed, base=base, frames=args.frames, seconds=round(secs, 1),
            nonfinite=[(i["frame"], i.get("nonfinite_lanes"),
                        [(ln["x"], ln["y"]) for ln in i.get("lanes", [])])
                       for i in entry["nonfinite"]])), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    total = sum(len(s["nonfinite"]) for s in record["seeds"])
    frames = sum(s["frames"] for s in record["seeds"])
    print(json.dumps(dict(card=record["card"], frames=frames,
                          nonfinite_frames=total,
                          finite=math.isclose(total, 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
