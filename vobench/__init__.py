"""Benchmark of revo_tpu_torch, the PyTorch and CUDA port of REVO's edge-based
visual odometry, on one NVIDIA H100.  ``python -m vobench.run --workload NAME
--seed N --seconds S --trace 0|1`` from the root of a checkout; README.md
says how cells, configurations, traffic mixes and per-layer metrics are
added."""
from __future__ import annotations

import importlib


def driver_for(cell: dict, seed: int, device):
    """The cell's driver (``vobench/drivers/<traffic's driver>.py``), set up
    and warmed up for ``seed`` on ``device``."""
    mod = importlib.import_module(f"vobench.drivers.{cell['traffic']['driver']}")
    return mod.Driver(cell, seed, device)
