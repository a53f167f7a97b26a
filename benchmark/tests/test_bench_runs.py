"""Every cell driven end to end on the CPU at a tiny size: the set-up,
the window, the check against the reference, the result line; then the
control and the planted faults, each of which must come out not correct.
"""

import json
import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import run as bench_run
from harness import check, spec
from tiny import tiny_run
from tools import faults

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
GEO = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


def _run(r):
    rec = spec.driver(r.config["driver"]).run(r)
    return bench_run.evaluate(r, rec)


DRY = """
import json, sys
sys.path[:0] = {paths!r}
import run as bench_run
from tiny import tiny_run
from tools import faults
r = tiny_run({cell!r})
code = bench_run.run_cell(r)
print(json.dumps(dict(code=code, found=bench_run.forbidden_modules())))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_holds_no_jax(cell):
    """A tiny run of the cell in a fresh process: it prints its result,
    is correct, and its process holds no jax, jaxlib, flax or
    visionaray_tpu module (top-level names compared whole)."""
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.dirname(os.path.dirname(here)), os.path.dirname(here),
             here]
    out = subprocess.run(
        [sys.executable, "-c", DRY.format(paths=paths, cell=cell)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result, tail = json.loads(lines[-2]), json.loads(lines[-1])
    assert tail == dict(code=0, found=[])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert set(result["metrics"]) == want


FAKE_JAX_IN_RANKS = """
import os, sys, types
if "RANK" in os.environ:
    sys.modules["jax"] = types.ModuleType("jax")
"""


@pytest.mark.parametrize("cell", GEO)
def test_jax_in_a_rank_refuses_the_run(cell, tmp_path):
    """A rank process that holds a module named jax makes the run exit 3
    with no result, though the parent holds none."""
    (tmp_path / "sitecustomize.py").write_text(FAKE_JAX_IN_RANKS)
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.dirname(os.path.dirname(here)), os.path.dirname(here),
             here]
    out = subprocess.run(
        [sys.executable, "-c", DRY.format(paths=paths, cell=cell)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join(
                     [str(tmp_path)] + [p for p in os.environ.get(
                         "PYTHONPATH", "").split(os.pathsep) if p])))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == dict(code=3, found=[])
    assert not any('"correct"' in line for line in lines)
    assert "loaded jax" in out.stderr


@pytest.mark.parametrize("cell", ONE_CARD[:1])
def test_jax_in_a_reader_refuses_the_run(cell, monkeypatch, capsys):
    """A per-layer reader that loads a module named jax, after the
    window has closed, makes the run exit 3 with no result."""
    import types
    real = spec.reader

    def reader(metric):
        mod = real(metric)

        def read(ctx):
            monkeypatch.setitem(sys.modules, "jax",
                                types.ModuleType("jax"))
            return mod.read(ctx)
        return types.SimpleNamespace(read=read)

    monkeypatch.setattr(spec, "reader", reader)
    assert bench_run.run_cell(tiny_run(cell, trace=True)) == 3
    assert '"correct"' not in capsys.readouterr().out


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "visionaray_tpu_extra", sys)
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench_run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_traced_run_reads_its_layers(cell):
    r = tiny_run(cell, trace=True)
    res = _run(r)
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res
    if r.traffic["kind"] == "train":
        assert 0 < res["metrics"]["backward_share.step"]["value"] < 100


@pytest.mark.parametrize("cell", ONE_CARD + GEO)
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place gives a finite
    reading of every number and fails the cell's limits."""
    r = tiny_run(cell)
    lim = spec.limits(cell)
    t = r.traffic
    if t["kind"] == "frame":
        from harness import pixels
        kept = dict(kind="frame", items=[(7, None), (8, None)],
                    lanes=pixels.sample(t["width"] * t["height"],
                                        t["check_pixels"], r.seed))
    else:
        kept = dict(kind="train", items=[(7, None, None, None)])
    nums = check.control(r.config, t, r.seed, kept, "cpu",
                         lim["pixel_tol"])
    assert all(np.isfinite(v) for v in nums.values()), nums
    ok, _ = check.judge(nums, lim["limits"])
    assert not ok, nums


# ------------------------------------------------------------- the faults
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", ONE_CARD)
def test_fault_is_not_correct(cell, fault):
    r = tiny_run(cell)
    r.seconds = 0.0      # the window still runs its first iteration
    undo = faults.plant(fault, r.traffic["kind"])
    try:
        # a stale answer is the warm-up's, kept since before the window
        rec = spec.driver(r.config["driver"]).run(r)
    finally:
        undo()
    res = bench_run.evaluate(r, rec)
    assert res["correct"] is False, res["checks"]


# ---------------------------------------------------- faults on the ranks
def _rank(rank, world, port, out, cell, fault):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if fault != "none":
        faults.plant(fault, "frame")
    r = tiny_run(cell)
    spec.driver(r.config["driver"]).rank_main(r, out)


@pytest.mark.parametrize("fault", ["none", "no_exchange", "altered"])
@pytest.mark.parametrize("cell", GEO)
def test_rank_faults(cell, fault, tmp_path):
    import socket
    r = tiny_run(cell)
    world = int(r.config["shards"])
    drv = spec.driver(r.config["driver"])
    drv.write_run(r, str(tmp_path))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(k, world, port, str(tmp_path),
                                             cell, fault))
             for k in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    rec = drv.collect(r, str(tmp_path), world)
    res = bench_run.evaluate(r, rec)
    assert res["correct"] is (fault == "none"), res["checks"]
    assert np.isfinite(res["metrics"]["sharded_frame_s"]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_on_the_card(cell):
    """A tiny run of the cell on the card: the kernels' path is checked
    against the reference and the result names the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = tiny_run(cell)
    r.device = "cuda"
    res = _run(r)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
