"""A cell cut to 160x120 and a few lanes, for CPU tests of the harness.
The program runs its plain versions on the CPU; only the size differs from
the cell as committed."""
from __future__ import annotations

import copy
from pathlib import Path

from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
SCALE = 0.25


def tiny_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    cam = c["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= SCALE
    cam["width"], cam["height"] = int(cam["width"] * SCALE), int(cam["height"] * SCALE)
    c["pyramid"]["edge_capacity"] = [int(x * SCALE * SCALE) for x in c["pyramid"]["edge_capacity"]]
    return c


def tiny_cell(workload: str, lanes: int = 2, root: Path = ROOT) -> dict:
    cell = harness.load_cell(workload, root)
    cell["config"] = tiny_config(cell["config"])
    tr = dict(cell["traffic"], lanes=lanes)
    if tr["driver"] == "scan":
        tr.update(frames=8, warmup_steps=4, samples=8, promoted_samples=2)
    cell["traffic"] = tr
    return cell
