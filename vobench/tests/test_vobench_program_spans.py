"""The seven readers of the program's own spans and counters
(``vobench/program_spans.py``) on a made-up traced segment and tracer
session: each reads its spans or counts over the segment's steps, and
each returns None where the session is empty, the run traced nothing, or
the program has no tracer."""
from __future__ import annotations

import builtins

import pytest

from vobench import harness, roofline

STEPS, LANES = 4, 8
MS = 1_000_000  # ns


def _totals(**ms):
    return {name.replace("__", "."): {"count": STEPS, "ns": ns * MS, "self_ns": self_ns * MS}
            for name, (ns, self_ns) in ms.items()}


SNAP = {
    "steps": STEPS,
    "spans": [],
    "totals": _totals(scan__step=(400, 8), scan__stack=(40, 36), scan__merge=(60, 52),
                      scan__promote=(24, 2), frontend__build=(20, 16), tracker__track=(30, 28),
                      host_read__scan__flags=(6, 6), host_read__lie__inv_lu=(10, 6)),
    "host_reads": {"scan.flags": STEPS, "lie.inv_lu": 2 * STEPS},
    "levels": [{"points": 4096, "evaluations": [5, 7]}, {"points": 16384, "evaluations": [6, 2]}],
    "level_kernel": {"launches": 2, "check_launches": 1, "layout_launches": [2, 0, 0, 0, 0]},
}
OBS = {"lanes": LANES, "config": {"optimizer": {"quad_form": "dt4bf"}},
       "trace": {"steps": STEPS, "device_ops": [["void solve_level_kernel<1>(...)", 2e-3, 2],
                                                ["canny_fused_kernel", 1e-3, 4]]}}
WANT = {
    "loop.lanes_ms_per_step": (36 + 52) / STEPS,
    "loop.host_wait_ms_per_step": (6 + 6) / STEPS,
    "keyframe.promote_ms_per_step": 24 / STEPS,
    "frontend.host_ms_per_step": 16 / STEPS,
    "solver.host_ms_per_step": 28 / STEPS,
    "solver.evaluations_per_lane_frame": 20 / (STEPS * LANES),
}
READERS = sorted(WANT) + ["revo_solve_level_roofline"]


@pytest.fixture
def session(monkeypatch):
    """The tracer's snapshot replaced by ``box[0]``."""
    from revo_tpu_torch.utils import trace

    box = [SNAP]
    monkeypatch.setattr(trace, "snapshot", lambda: box[0])
    return box


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_takes_its_spans_over_the_segments_steps(session, metric):
    assert harness.reader(metric).read(OBS) == pytest.approx(WANT[metric], rel=1e-12)


def test_roofline_counts_evaluations_points_and_rows(session):
    flops = 12 * (166 * 4096 + 520) + 8 * (166 * 16384 + 520)
    n_bytes = 2 * 4096 * (13 + 8) + 2 * 16384 * (13 + 8)
    want = 100.0 * roofline.least_seconds(n_bytes, flops) / 2e-3
    got = harness.reader("revo_solve_level_roofline").read(OBS)
    assert got == pytest.approx(want, rel=1e-12) and 0.0 < got < 100.0
    # The operations bound here: the bytes' time is the smaller.
    assert n_bytes / roofline.PEAK_BYTES_PER_S < flops / roofline.PEAK_F32_FLOPS


@pytest.mark.parametrize("metric", READERS)
def test_reader_finds_nothing_in_an_empty_session(session, metric):
    session[0] = {"steps": 0, "spans": [], "totals": {}, "host_reads": {}, "levels": [],
                  "level_kernel": {}}
    assert harness.reader(metric).read(OBS) is None
    session[0] = SNAP
    assert harness.reader(metric).read({k: v for k, v in OBS.items() if k != "trace"}) is None
    assert harness.reader(metric).read(dict(OBS, trace=dict(OBS["trace"], steps=0))) is None


@pytest.mark.parametrize("metric", READERS)
def test_reader_returns_none_without_the_programs_tracer(monkeypatch, metric):
    real = builtins.__import__

    def no_tracer(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "revo_tpu_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("cannot import name 'trace'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert harness.reader(metric).read(OBS) is None


def test_a_real_session_reads_back(monkeypatch):
    """The tracer's own snapshot, not a made-up one: two steps of spans."""
    from revo_tpu_torch.utils import trace

    trace.enable()
    try:
        for _ in range(2):
            with trace.span("scan.step"):
                with trace.span("scan.stack"):
                    pass
                with trace.span("scan.merge"):
                    with trace.host_read("scan.flags"):
                        pass
    finally:
        trace.disable()
    obs = dict(OBS, trace=dict(OBS["trace"], steps=2))
    lanes = harness.reader("loop.lanes_ms_per_step").read(obs)
    wait = harness.reader("loop.host_wait_ms_per_step").read(obs)
    assert lanes > 0.0 and wait > 0.0
    assert harness.reader("keyframe.promote_ms_per_step").read(obs) == 0.0
    assert harness.reader("solver.evaluations_per_lane_frame").read(obs) is None
