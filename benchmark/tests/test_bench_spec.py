"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name."""

import json
import re

import pytest

from harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.endswith("_torch") and (spec.ROOT / p).is_dir()


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        moved = [m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"]]
        assert moved and set(metric.get("workloads", CELLS)) <= set(
            moved[0].get("workloads", CELLS))
        assert 1 <= len(metric["layer"]) <= 200


def test_unique_names_and_cells():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}


def test_setup_s_in_every_cell():
    """``setup_s`` lists no cells, so every cell, a later one too, reports
    it."""
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    config = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    assert traffic["kind"] in ("train", "frame")
    assert config["chips"] == w["chips"]
    assert hasattr(spec.driver(config["driver"]), "run")
    assert hasattr(spec.scene_module(config["scene"]["generator"]), "build")
    lim = spec.limits(cell)
    assert lim["limits"] and lim["pixel_tol"] > 0


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    config = spec.config(BENCH, entry["name"])
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_layer_metric_reader_found(metric):
    assert callable(spec.reader(metric).read)


def test_reader_falls_back_to_its_family():
    """A metric with no file of its own is read by its family's file, so a
    later cell's ``idle_share.<kind>`` needs no new reader."""
    fam = spec.reader("idle_share.some_new_kind")
    assert fam.__file__.endswith("layer_metrics/idle_share.py")
    with pytest.raises(SystemExit):
        spec.reader("no_such_family.frame")


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        spec.cell(BENCH, "no.such.cell")
