"""The control: the reference computed in bfloat16, the precision below
the configurations' float32, in the program's place, fails the limits,
here at 160x120 on the CPU (on the card at the cells' own sizes:
``python -m vobench.control``)."""
from __future__ import annotations

import pytest
import torch

from vobench import control
from vobench.tests._tiny import tiny_cell


@pytest.mark.parametrize("workload", ["tum_fr1.track_chain", "tum_fr1.scan_desk"])
def test_control_fails_the_limits(workload):
    cell = tiny_cell(workload, lanes=2)
    out = control.readings(cell, 77, 3.0, {"control": [77], "witness": []},
                           torch.device("cpu"))
    limits = cell["limits"]
    failed = [k for k, v in out["control"].items() if k in limits and v > limits[k]]
    assert failed, out
    # The front end and keyframe numbers hold at this size for the program.
    for k in ("gray", "edges", "depth_m", "cloud_m", "kf_table"):
        assert out["program"][k] <= limits[k], (k, out)
