"""Runs of the benchmark's cells at a size a CPU test can hold: the same
files, drivers and checks, with a smaller scene and frame."""

from __future__ import annotations

import run as bench_run


def tiny_run(cell: str, seed: int = 123456789012, trace: bool = False):
    args = bench_run.parse(["--workload", cell, "--seed", str(seed),
                            "--seconds", "0.2", "--trace", str(int(trace))])
    r = bench_run.make_run(args)
    r.device = "cpu"
    r.config["scene"]["target_tris"] = 600
    r.traffic.update(width=16, height=8, tile=64, check_pixels=48,
                     warm=1, trace_iterations=1)
    return r
