"""The port's tracer: named spans at the step's layer boundaries, the host's
blocking reads by site, and the level kernel's evaluations, kept in memory.

Tracing is on while ``enable()`` holds it on (the operator's switch, until
``disable()``) or while a torch profiler records
(``torch.autograd.profiler._is_profiler_enabled``), and off otherwise.

- Off, ``span(name)`` returns one shared no-op after a check of two flags:
  no allocation, no clock read, no torch call.
- On, a span records its name, its parent, the step it belongs to and its
  host start and end (``time.perf_counter_ns``).  While a profiler records
  it also opens ``torch.profiler.record_function(name)``, so the span lies
  in the profiler's timeline on the clock of the device's kernels and
  copies.
- The first span or read that finds tracing on after it was off starts a
  new session and drops the last one's records; ``snapshot()`` reads the
  last session.  A step is a root span of the name the session's first root
  span had (``scan.step`` in the scan, ``frontend.build`` in a loop of
  build and track); a host-read span never starts a step.
- While a session records, each pass of Python's garbage collector is a
  ``gc`` span under the span that was open, so self times leave the
  collector's pauses out.
- ``host_read(site)`` goes around a blocking copy or synchronise on the
  step's path: ``host_reads[site]`` counts it whether tracing is on or
  not, and while tracing is on it is a ``host_read.<site>`` span.
- ``level_launch(evaluations, points)``: each level of the solver, kernel
  or plain loop, hands over the evaluations each lane ran, a tensor it
  already wrote; ``snapshot()`` sums them when it is read.

Spans are recorded from one thread, the one that steps the system.  Names
are dotted (``scan.*``, ``frontend.*``, ``tracker.*``, ``keyframe.*``,
``host_read.*``, ``gc``) and are none of a caller's own span names.
``trace_to`` writes a profiler's Chrome trace, the program's spans in it.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time
from collections import Counter
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

# Blocking reads by site since the process started, counted with tracing off
# too (lm's live-lane reads keep their own count, ``lm_level_batched.host_reads``).
host_reads: Counter = Counter()

_enabled = False
_live = False  # a session is recording
_session = None


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def _level_counts() -> dict:
    from revo_tpu_torch import solver

    k = solver.solve_level_kernel
    return {"launches": k.launches, "check_launches": k.check_launches,
            "layout_launches": list(k.layout_launches)}


class _Session:
    def __init__(self):
        self.spans = []  # [name, parent index or -1, step, start ns, end ns (0: open)]
        self.open = []  # indices of the open spans, innermost last
        self.root = None  # the first root span's name: each root of it starts a step
        self.step = -1
        self.reads = Counter()
        self.levels = []  # (evaluations (B,) int32, points a lane) a level
        self.level_lists = []  # each level's evaluations as a list, once read
        self.gc_open = None
        self.kernel0 = _level_counts()
        self.kernel1 = None


def on() -> bool:
    """Whether spans record now."""
    return _enabled or _profiler._is_profiler_enabled


def _current() -> _Session:
    global _session, _live
    if not _live:
        _session, _live = _Session(), True
        gc.callbacks.append(_gc_hook)
    return _session


def _close() -> None:
    global _live
    _live = False
    _session.kernel1 = _level_counts()
    if _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)


def enable() -> None:
    """Turn tracing on until ``disable()``: a new session starts unless a
    profiler's is recording."""
    global _enabled
    if not on() and _live:
        _close()
    _enabled = True
    _current()


def disable() -> None:
    """Turn the operator's switch off; a recording profiler keeps the
    session on."""
    global _enabled
    _enabled = False
    if _live and not on():
        _close()


class _Span:
    __slots__ = ("name", "session", "index", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = self.session = _current()
        parent = s.open[-1] if s.open else -1
        if parent < 0:
            if s.root is None and not self.name.startswith("host_read."):
                s.root = self.name
            if self.name == s.root:
                s.step += 1
        self.record = None
        if _profiler._is_profiler_enabled:
            self.record = _profiler.record_function(self.name)
            self.record.__enter__()
        self.index = len(s.spans)
        s.open.append(self.index)
        s.spans.append([self.name, parent, max(s.step, 0), time.perf_counter_ns(), 0])
        return None

    def __exit__(self, *exc):
        s = self.session
        s.spans[self.index][4] = time.perf_counter_ns()
        s.open.pop()
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str):
    """A span over the ``with`` block, or the shared no-op while tracing is
    off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        if _live:
            _close()
        return NOOP
    return _Span(name)


def host_read(site: str, counted: bool = True):
    """Around one blocking read of the step's path: counts it in
    ``host_reads[site]`` (``counted``: False where the site keeps its own
    count) and, while tracing is on, in the session and as a
    ``host_read.<site>`` span."""
    if counted:
        host_reads[site] += 1
    if not (_enabled or _profiler._is_profiler_enabled):
        if _live:
            _close()
        return NOOP
    _current().reads[site] += 1
    return _Span("host_read." + site)


def level_launch(evaluations: torch.Tensor, points: int) -> None:
    """One solver level over B lanes: ``evaluations`` (B,) the evaluations
    each lane ran (kept by reference while tracing is on, read at
    ``snapshot()``), ``points`` the cloud's capacity a lane."""
    if _enabled or _profiler._is_profiler_enabled:
        _current().levels.append((evaluations, int(points)))


def _gc_hook(phase, info) -> None:
    if not _live:
        return
    s = _session
    if phase == "start":
        record = None
        if _profiler._is_profiler_enabled:
            record = _profiler.record_function("gc")
            record.__enter__()
        s.gc_open = (s.open[-1] if s.open else -1, time.perf_counter_ns(), record)
    elif s.gc_open is not None:
        parent, t0, record = s.gc_open
        s.gc_open = None
        if record is not None:
            record.__exit__(None, None, None)
        s.spans.append(["gc", parent, max(s.step, 0), t0, time.perf_counter_ns()])


def _level_evaluations(s: _Session) -> list:
    """Each level's evaluations a lane as a list: one host read a device
    for the levels not read yet, made here and not on the step's path."""
    todo = range(len(s.level_lists), len(s.levels))
    lists = {}
    for dev in {s.levels[i][0].device for i in todo}:
        idx = [i for i in todo if s.levels[i][0].device == dev]
        flat = torch.cat([s.levels[i][0].reshape(-1) for i in idx]).tolist()
        at = 0
        for i in idx:
            n = s.levels[i][0].numel()
            lists[i] = flat[at:at + n]
            at += n
    s.level_lists.extend(lists[i] for i in todo)
    return s.level_lists


def snapshot() -> dict:
    """The last session's records:

    - ``steps``: the steps it began;
    - ``spans``: each span as a dict of ``name``, ``parent`` (an index into
      the list, -1 at the root), ``step``, ``start_ns``, ``end_ns`` and
      ``self_ns`` (its duration less what its children cover; a span still
      open ends now);
    - ``totals``: by name, ``count``, ``ns`` and ``self_ns``;
    - ``host_reads``: the session's blocking reads by site;
    - ``levels``: each solver level, in order, as a dict of ``points`` (a
      lane's cloud capacity) and ``evaluations`` (a list, one a lane);
    - ``level_kernel``: the session's ``solve_level_kernel`` launches, those
      with the init check, and the launches by table layout, from the
      wrapper's own counters.

    Empty (``steps`` 0) before any session."""
    if _live and not on():
        _close()
    s = _session
    if s is None:
        return {"steps": 0, "spans": [], "totals": {}, "host_reads": {}, "levels": [],
                "level_kernel": {}}
    now = time.perf_counter_ns()
    ends = [t1 or now for _, _, _, _, t1 in s.spans]
    covered = [0] * len(s.spans)
    for i, (_, parent, _, t0, _) in enumerate(s.spans):
        if parent >= 0:
            covered[parent] += ends[i] - t0
    spans, totals = [], {}
    for i, (name, parent, step, t0, _) in enumerate(s.spans):
        own = ends[i] - t0 - covered[i]
        spans.append({"name": name, "parent": parent, "step": step, "start_ns": t0,
                      "end_ns": ends[i], "self_ns": own})
        tot = totals.setdefault(name, {"count": 0, "ns": 0, "self_ns": 0})
        tot["count"] += 1
        tot["ns"] += ends[i] - t0
        tot["self_ns"] += own
    k0, k1 = s.kernel0, s.kernel1 if s.kernel1 is not None else _level_counts()
    kernel = {"launches": k1["launches"] - k0["launches"],
              "check_launches": k1["check_launches"] - k0["check_launches"],
              "layout_launches": [b - a for a, b in zip(k0["layout_launches"],
                                                        k1["layout_launches"])]}
    levels = [{"points": p, "evaluations": ev}
              for (_, p), ev in zip(s.levels, _level_evaluations(s))]
    return {"steps": s.step + 1, "spans": spans, "totals": totals,
            "host_reads": dict(s.reads), "levels": levels, "level_kernel": kernel}


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """torch.profiler over the block: writes a Chrome trace (``trace.json``)
    into ``log_dir``, the program's spans in it as user annotations; no-op
    when log_dir is None.  CUDA activity is traced when a card is
    present."""
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
