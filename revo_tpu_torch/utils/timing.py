"""Wall timing that waits for the device + per-stage collectors (counterpart
of revo_tpu/utils/timing.py).

Replaces the reference's Timer (utils/timer.h:23-41) and its static timing
vectors (ImgPyramidRGBD::dtTimes imgpyramidrgbd.cpp:23,250; trackingTimes
system.cpp:246) with context managers that synchronize the device before
stopping the clock, plus a torch.profiler trace helper.  The device is an
explicit argument: a CUDA device is synchronized (and a failing synchronize
raises), the CPU needs nothing.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


def _synchronize(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """``with Timer(device) as t: ...; t.ms``: waits for ``device``'s
    outstanding work before it stops the clock (``sync=False``: host time
    only)."""

    def __init__(self, device="cuda", sync: bool = True):
        self.device = torch.device(device)
        self.sync = sync
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _synchronize(self.device)
        self.ms = (time.perf_counter() - self._t0) * 1000.0


class StageTimes:
    """Named per-stage wall-time series, like dtTimes/trackingTimes."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        """Time the block; with ``device`` given, wait for that device's
        work before stopping the clock (the counterpart of the JAX
        ``result=`` argument and its ``block_until_ready``)."""
        t0 = time.perf_counter()
        yield
        if device is not None:
            _synchronize(device)
        self._times[name].append((time.perf_counter() - t0) * 1000.0)

    def add(self, name: str, ms: float) -> None:
        self._times[name].append(ms)

    def mean(self, name: str) -> float:
        xs = self._times.get(name, [])
        return sum(xs) / len(xs) if xs else 0.0

    def report(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self._times}


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """torch.profiler trace scope: writes a Chrome trace (``trace.json``)
    into ``log_dir``; no-op when log_dir is None.  CUDA activity is traced
    when a card is present."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
