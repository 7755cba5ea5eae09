"""BENCHMARK.json against the benchmark's contract, and every file of a
cell found by name: the characters of names and units, the keys of each
entry, each per-layer metric's `moves` reported wherever the metric is,
each cell reporting `setup_s`, another end-to-end metric and a per-layer
metric, the configuration, traffic and reader files, and the limits each
configuration states for the loops it runs under."""

import json
import os
import re

import pytest

from benchmark.harness import Spec

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_configs_files_and_reduced():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and len(c["reduced"]) <= 16
        assert set(c["reduced"]) == set(conf["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = Spec(cell)
    assert spec.cell["chips"] == 1
    assert spec.traffic["loop"] in ("views", "train_steps")
    # the configuration states a limit for each number its loop compares
    assert spec.traffic["loop"] in spec.conf["limits"]
    e2e = {m["name"] for m in spec.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer()
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))


def test_each_per_layer_metric_moves_one_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_layer_names_are_one_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x.split()) <= 6 for x in layers)
