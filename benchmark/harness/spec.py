"""What the benchmark runs, found by name.

``BENCHMARK.json`` at the root names the cells (``workloads``), each a
configuration and a traffic mix, and the metrics.  Every piece that
belongs to one name is a file of its own, found from that name:

- a configuration: the ``file`` its entry gives (``configs/<name>.json``):
  the scene, its render settings, the driver that runs it and the chips;
- a traffic mix: ``traffic/<name>.json``: kind, sizes, warm iterations;
- a per-layer metric: ``layer_metrics/<name>.py``, or where there is no
  such file the reader of its family, ``layer_metrics/<family>.py`` (the
  name before its first dot: ``idle_share.py`` serves ``idle_share.step``
  and ``idle_share.frame``); its ``read(ctx)`` returns the value or None
  when the run has nothing to read;
- a cell's correctness limits: ``checks/<cell>.json``;
- a driver: ``drivers/<name>.py``, the program's side of a run;
- a scene generator: ``scenes/<name>.py``, which both sides are given.

Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # benchmark/
ROOT = HERE.parent                               # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json (cells: "
                     f"{', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "checks" / f"{cell_name}.json")


def _module(path: Path, label: str):
    if not path.is_file():
        raise SystemExit(f"{label}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{label}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(HERE / "drivers" / f"{name}.py", "driver")


def scene_module(name: str):
    return _module(HERE / "scenes" / f"{name}.py", "scene")


def reader(metric: str):
    own = HERE / "layer_metrics" / f"{metric}.py"
    family = HERE / "layer_metrics" / f"{metric.split('.')[0]}.py"
    return _module(own if own.is_file() else family, "metric")


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` entries: those that list
    it under ``workloads`` or list no cells at all."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
