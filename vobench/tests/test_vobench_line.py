"""A run's last line, from a CPU run of each driver at 160x120: the keys
the driver reads, every metric the cell names with its unit, and the
checks last, each number beside its limit."""
from __future__ import annotations

import json

import pytest
import torch

from vobench import harness
from vobench.tests._tiny import tiny_cell


@pytest.mark.parametrize("workload,trace", [("tum_fr1.track_chain", False),
                                            ("tum_fr1.scan_desk", True)])
def test_cpu_line_is_well_formed(workload, trace):
    cell = tiny_cell(workload, lanes=2)
    line = json.loads(json.dumps(harness.run_cell(cell, 2**31 + 12345, 3.0, trace,
                                                  torch.device("cpu"))))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
    if trace:
        units.update({m["name"]: m["unit"] for m in cell["per_layer"]})
    for name, m in line["metrics"].items():
        assert units[name] == m["unit"] and m["value"] == m["value"]
    assert set(units) - set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}
    assert {"setup_s", "lane_frames_per_s"} <= set(line["metrics"])
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"} and check["limit"] == cell["limits"][name]
