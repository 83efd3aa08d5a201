"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and entries, with no edit to a file under vobench/, run at a
tiny size from a copy of the benchmark."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from vobench.tests._tiny import ROOT, tiny_config

RUN = """
import json, sys, torch
from pathlib import Path
from vobench import harness
cell = harness.load_cell("tiny_fr1.track_short", Path.cwd())
print(json.dumps(harness.run_cell(cell, 99, 10.0, True, torch.device("cpu"))))
"""


def test_cell_added_as_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    vb = tmp_path / "vobench"
    config = tiny_config(json.loads((vb / "configs" / "tum_fr1.json").read_text()))
    (vb / "configs" / "tiny_fr1.json").write_text(json.dumps(config))
    (vb / "traffic" / "track_short.json").write_text(json.dumps(
        {"driver": "track", "lanes": 2, "frames": 4, "chain": 4, "step_mm": 8.0, "step_deg": 0.17}))
    (vb / "limits" / "tiny_fr1.track_short.json").write_text(json.dumps({"gray": 0.5}))
    (vb / "layer_metrics" / "track.lanes_per_step.py").write_text(
        "def read(obs):\n    return obs['lanes']\n")
    bench["configs"].append({"name": "tiny_fr1", "source": "https://github.com/fabianschenk/REVO",
                             "file": "vobench/configs/tiny_fr1.json", "reduced": [],
                             "why": "a test's cell"})
    bench["workloads"].append({"name": "tiny_fr1.track_short", "config": "tiny_fr1",
                               "traffic": "track_short", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "track.lanes_per_step", "unit": "lanes", "better": "higher",
                               "source": "program_counter", "layer": "Solver",
                               "moves": "lane_frames_per_s", "workloads": ["tiny_fr1.track_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["track.lanes_per_step"] == {"value": 2.0, "unit": "lanes"}
    assert line["checks"]["gray"] == {"value": 0.0, "limit": 0.5}
    assert line["attempted"] > 0
