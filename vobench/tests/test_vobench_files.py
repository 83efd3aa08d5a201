"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, limits and per-layer readers are found by name, and the
entries keep to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from vobench import harness
from vobench.tests._tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vobench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload, ROOT)
    assert cell["traffic"]["driver"] in ("scan", "track")
    assert cell["limits"], "every cell has its limits file"
    assert set(cell["limits"]) <= {"flags", "gray", "depth_m", "edges",
                                   "cloud_m", "kf_table", "cost_gap", "cost_share"}
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert hasattr(harness.reader(m["name"]), "read")


def test_names_units_and_layers():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_holds_what_runs(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["reduced"] == [] and cfg["reduced"] == []
    from vobench import common

    pc = common.port_config(cfg)
    assert pc.camera.width == 640 and pc.camera.height == 480
    assert pc.pyramid.edge_capacity == tuple(cfg["pyramid"]["edge_capacity"])
