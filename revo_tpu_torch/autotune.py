"""Capacity calibration: size the fixed edge-cloud capacities to the scene
(counterpart of revo_tpu/autotune.py).

Every pyramid level's cloud has a fixed lane count
(``PyramidConfig.edge_capacity``), and the solver gathers and masks all of
them, so padded lanes cost real time.  Calibration probes a few frames'
per-level edge counts and fits the capacities to them, times a margin:
above 1 tracking is unchanged while no frame overflows; below 1 the
compaction's uniform stride decimation subsamples the edges on purpose
(revo_tpu/autotune.py records the accuracy of those operating points).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import torch

from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import edge_levels
from revo_tpu_torch.kernels import check_device


def fit_capacities(
    counts_per_level: Sequence[Sequence[int]],
    margin: float = 1.15,
    quantum: int = 256,
    minimum: int = 1024,
) -> Tuple[int, ...]:
    """Per-level capacity = round_up(max observed count * margin, quantum),
    at least ``minimum``."""
    caps = []
    for counts in counts_per_level:
        counts = list(counts)
        if counts:
            want = max(minimum, int(max(int(c) for c in counts) * margin))
        else:
            want = minimum
        caps.append(-(-want // quantum) * quantum)
    return tuple(caps)


def probe_counts(cfg: SystemConfig, gray, depth, device) -> List[int]:
    """Per-level valid-edge-point counts of one frame on ``device``: the
    pyramid front end (Canny, which launches K1 and K2 on a CUDA device,
    fill-in and the validity predicate) without the cloud compaction."""
    pyr = cfg.pyramid
    out = [
        (edges & torch.isfinite(d) & (d > pyr.depth_min) & (d < pyr.depth_max)).sum()
        for _, d, _, edges in edge_levels(
            torch.as_tensor(gray).to(device), torch.as_tensor(depth).to(device), cfg
        )
    ]
    return [int(c) for c in torch.stack(out).tolist()]


def calibrate_capacities(
    cfg: SystemConfig,
    grays: Iterable,
    depths: Iterable,
    margin: float = 1.15,
    quantum: int = 256,
    *,
    device,
) -> SystemConfig:
    """Probe a few frames (2-5 representative ones) on ``device`` and return
    ``cfg`` with ``edge_capacity`` fitted to the observed counts."""
    device = check_device(device)
    n_levels = cfg.pyramid.n_levels
    counts = [[] for _ in range(n_levels)]
    for g, d in zip(grays, depths):
        for lvl, c in enumerate(probe_counts(cfg, g, d, device)):
            counts[lvl].append(c)
    caps = fit_capacities(counts, margin=margin, quantum=quantum)
    return dataclasses.replace(cfg, pyramid=dataclasses.replace(cfg.pyramid, edge_capacity=caps))
