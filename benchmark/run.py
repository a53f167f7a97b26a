#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, driver, correctness limits and per-layer
readers are found by name (``harness/spec.py``).  The run needs as many
CUDA cards as the cell asks for and fails without them.  It sets up the
program, warms every shape the mix uses, measures for ``--seconds``
(``--trace 1``: with spans and a profiled stretch after the window),
checks the program's outputs against the plain reference, and prints
one JSON object as the last line of standard output; the compared
numbers, each beside its limit, are the last lines of standard error.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program and its libraries at a fixed place in the
# checkout (the kernels' library builds under build/visionaray_torch/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(HERE)]

from harness.modules import forbidden_modules  # noqa: E402

GIB = float(1 << 30)


@dataclass
class Run:
    """One run's inputs, handed to the cell's driver."""

    bench: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start_wall: float = T_START


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line(n: int) -> str:
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return (f"card: {torch.cuda.get_device_name(0)} x {n}; nvidia-smi: "
            f"{' | '.join(smi[:n]) or 'not available'}; torch "
            f"{torch.__version__} CUDA {torch.version.cuda}")


def end_to_end(run: Run, rec: dict) -> dict:
    from harness import window
    w = rec["window"]
    return {rec["rate"]: (window.per_iteration(w), "s"),
            "p95_s": (window.p95(w.times), "s"),
            "peak_mem_gib": (rec["peak_window_bytes"] / GIB, "GiB"),
            "setup_s": (rec["setup_s"], "s")}


def per_layer(run: Run, rec: dict, wanted: list) -> dict:
    from harness import spec
    ctx = dict(cell=run.cell, config=run.config, traffic=run.traffic,
               traces=rec["traces"], spans=rec["spans"],
               counters=rec["counters"], shapes=rec["shapes"],
               window=rec["window"])
    out = {}
    for m in wanted:
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = (v, m["unit"])
    return out


def breakdown(traces: list) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, as means over the ranks."""
    from collections import defaultdict

    from harness.trace import top
    ops, gaps = defaultdict(float), defaultdict(float)
    for s in traces:
        for n, v in s["ops"].items():
            ops[n] += v / len(traces)
        for n, v in s["gaps"].items():
            gaps[n] += v / len(traces)
    return dict(device_ops=top(ops), idle_gaps=top(gaps))


def evaluate(run: Run, rec: dict) -> dict:
    """The result of a run from its driver's record: the check against
    the reference, then the cell's metrics."""
    import torch

    from harness import check, spec
    lim = spec.limits(run.cell["name"])
    ref = check.reference_outputs(run.config, run.traffic, run.seed,
                                  rec["kept"], run.device)
    nums = check.numbers(rec["kept"], ref, lim["pixel_tol"])
    correct, checks = check.judge(nums, lim["limits"])
    kind = "per_layer" if run.trace else "end_to_end"
    wanted = spec.metrics_of(run.bench, run.cell["name"], kind)
    got = per_layer(run, rec, wanted) if run.trace else end_to_end(run, rec)
    names = [m["name"] for m in wanted]
    if not run.trace and set(names) - set(got):
        raise RuntimeError(f"no value for {sorted(set(names) - set(got))}")
    cuda = run.device == "cuda"
    device = dict(platform="gpu" if cuda else "cpu",
                  kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                  count=int(run.cell["chips"]),
                  memory_peak_bytes=int(rec["memory_peak_bytes"]))
    result = dict(correct=bool(correct), attempted=int(rec["attempted"]),
                  failed=int(rec["failed"]),
                  metrics={n: dict(value=got[n][0], unit=got[n][1])
                           for n in names if n in got},
                  device=device)
    if run.trace:
        tr = rec["traces"]
        device["busy_s"] = sum(s["busy_s"] for s in tr) / len(tr)
        device["window_s"] = sum(s["window_s"] for s in tr) / len(tr)
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    return result


def run_cell(run: Run) -> int:
    import torch

    from harness import spec
    chips = int(run.cell["chips"])
    if run.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            log(f"run.py: {run.cell['name']} needs {chips} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}; no result")
            return 2
        log(card_line(chips))
    rec = spec.driver(run.config["driver"]).run(run)
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    result = evaluate(run, rec)
    # after the check and the readers, in this process and in every rank
    found = sorted(set(forbidden_modules()) | set(rec.get("forbidden", ())))
    if found:
        log(f"run.py: the run loaded {', '.join(found)}; no result")
        return 3
    w = rec["window"]
    log(f"window: {w.count} iterations in {w.seconds:.4f} s; host CPU "
        f"{w.cpu_s:.3f} s, {w.preempted} involuntary switches; setup_s "
        f"{rec['setup_s']:.3f}; counters {json.dumps(rec['counters'])}")
    if run.trace:
        tr = rec["traces"]
        log("traced: " + "; ".join(
            f"busy {s['busy_s']:.6f} s of {s['window_s']:.6f} s"
            for s in tr) + f" ({rec['shapes']['traced_iterations']} "
            f"iterations a rank)")
    print(json.dumps(result), flush=True)
    log(f"correct {result['correct']}")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}")
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def make_run(args) -> Run:
    from harness import spec
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    return Run(bench=bench, cell=cell,
               config=spec.config(bench, cell["config"], ROOT),
               traffic=spec.traffic(cell["traffic"]), seed=args.seed,
               seconds=args.seconds, trace=bool(args.trace))


def main(argv=None) -> int:
    args = parse(argv)
    run = make_run(args)
    if args.rank_worker is not None:
        from harness import spec
        return spec.driver(run.config["driver"]).rank_main(
            run, args.rank_worker)
    return run_cell(run)


if __name__ == "__main__":
    sys.exit(main())
