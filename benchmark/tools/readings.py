#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--control] [--control-only] [--fault NAME]

For each seed, in one process: the program's short window at the cell's
own sizes and its compared numbers against the reference (the lower
readings), and with ``--control`` the control's numbers on the same
frames or steps: the reference computed in bfloat16 put in the program's
place (the upper readings).  ``--control-only`` reads the control alone,
without the program (one card is enough for any cell).  One JSON line a
seed on standard output.  ``--fault`` plants one of ``tools/faults.py``'s
faults in the program first, for a fault's readings.  The benchmark's own
runs do not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import run as bench_run  # noqa: E402
from tools import faults  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--control-only", action="store_true")
    p.add_argument("--fault", default=None,
                   help="plant a fault of tools/faults.py in the program")
    a = p.parse_args()
    import torch

    from harness import check, pixels, spec, window
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    for seed in [int(s) for s in a.seeds.split(",")]:
        args = bench_run.parse(["--workload", a.workload, "--seed",
                                str(seed), "--seconds", str(a.seconds)])
        r = bench_run.make_run(args)
        tol = spec.limits(a.workload)["pixel_tol"]
        t, out = r.traffic, dict(seed=seed)
        t0 = time.time()
        if a.control_only:
            f0 = window.first_frame(seed, t["warm"])
            if t["kind"] == "frame":
                kept = dict(kind="frame", items=[(f0, None), (f0 + 1, None)],
                            lanes=pixels.sample(t["width"] * t["height"],
                                                t["check_pixels"], seed))
            else:
                kept = dict(kind="train", items=[(f0, None, None, None)])
        else:
            undo = faults.plant(a.fault, t["kind"]) if a.fault else None
            rec = spec.driver(r.config["driver"]).run(r)
            if undo:
                undo()
            kept = rec["kept"]
            out["iterations"] = rec["window"].count
            del rec
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.time()
        ref = check.reference_outputs(r.config, t, seed, kept, "cuda")
        out["reference_s"] = time.time() - t0
        if not a.control_only:
            out["program"] = check.numbers(kept, ref, tol)
        if a.control or a.control_only:
            out["control"] = check.control(r.config, t, seed, kept, "cuda",
                                           tol, ref)
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
