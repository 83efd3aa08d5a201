"""The port's tracer (revo_tpu_torch/utils/trace.py) on the CPU: off, a span
is the shared no-op; ``enable`` / ``disable`` and a profiler start
sessions; one scan step at 160x120 over B = 2 lanes records ``scan.step``
with its phases, parent links and self times, and the same spans lie nested
in the profiler's Chrome trace; a collection is a ``gc`` span; host reads
count by site; the plain level loop hands over the evaluations that
``solver.solve_level_ref`` counts; ``utils.trace_to`` writes the spans.
"""
import gc
import json
import time

import numpy as np
import pytest
import torch

from revo_tpu_torch import frontend, lie, solver, system, utils
from revo_tpu_torch.io import synthetic as syn
from revo_tpu_torch.parallel import batch
from revo_tpu_torch.utils import trace

from _torch_inputs import small_config
from test_torch_solver_step import EXIT_CASES, _cam, _seeded_lanes

torch.set_num_threads(1)

LANES = 2
# The benchmark's own spans (vobench/harness.py's SPANS), which no program
# span may reuse.
HARNESS_SPANS = {"build", "track", "read", "scan_step"}
PHASES = {"scan.stack", "frontend.build", "tracker.track", "keyframe.vote", "scan.gate",
          "scan.promote", "scan.merge"}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with the operator's switch off."""
    trace.disable()
    yield
    trace.disable()


def _frames(cfg, n):
    """n frames of a lateral pan (4 cm, ~1 degree a frame), as (n, H, W)
    gray and depth."""
    scene = syn.SyntheticScene()
    step = lie.matrix_from_rt(*lie.exp_se3(torch.tensor([0.04, 0.0, 0.005, 0.0, 0.017, 0.0])))
    T, grays, depths = np.eye(4, dtype=np.float32), [], []
    for _ in range(n):
        g, d = syn.render_frame(scene, cfg.camera, T)
        grays.append(g)
        depths.append(d)
        T = T @ step.numpy()
    return torch.from_numpy(np.stack(grays)), torch.from_numpy(np.stack(depths))


@pytest.fixture(scope="module")
def scan_run(tmp_path_factory):
    """Two scan steps of two lanes under a CPU profiler, the second with
    every lane's vote forced to promote: (snapshot, the Chrome trace's
    events, the host reads the steps counted by site)."""
    cfg = small_config()
    grays, depths = _frames(cfg, 3)
    lanes = [torch.stack([grays[i]] * LANES) for i in range(3)]
    dlanes = [torch.stack([depths[i]] * LANES) for i in range(3)]
    states = batch._init_states(frontend.build_frame_batched(lanes[0], dlanes[0], cfg), cfg)
    real_vote = system.tracker.assess_tracking_quality_batched

    def promote_all(past, est, frame, cfg_):
        real_vote(past, est, frame, cfg_)
        return torch.ones(est.shape[0], dtype=torch.bool)

    reads0 = dict(trace.host_reads)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        states, _ = batch._vo_scan_step_batched(states, lanes[1], dlanes[1], cfg)
        system.tracker.assess_tracking_quality_batched = promote_all
        try:
            states, out = batch._vo_scan_step_batched(states, lanes[2], dlanes[2], cfg)
        finally:
            system.tracker.assess_tracking_quality_batched = real_vote
    assert all(f[0] for f in out.flags)  # both lanes promoted in the second step
    snap = trace.snapshot()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    reads = {k: v - reads0.get(k, 0) for k, v in trace.host_reads.items()}
    return snap, events, reads


def test_off_a_span_is_the_shared_noop_and_records_nothing(monkeypatch):
    trace.snapshot()  # closes any session a profiler left
    before = trace.snapshot()

    def touched(*a, **k):
        raise AssertionError("tracing off touched the clock or torch")

    monkeypatch.setattr(trace.time, "perf_counter_ns", touched)
    monkeypatch.setattr(trace._profiler, "record_function", touched)
    assert not trace.on()
    assert trace.span("scan.step") is trace.NOOP and trace.span("x") is trace.NOOP
    n = trace.host_reads["test.site"]
    with trace.span("scan.step"), trace.host_read("test.site") as inner:
        assert inner is None
    trace.level_launch(torch.ones(2, dtype=torch.int32), 16)
    assert trace.host_reads["test.site"] == n + 1  # counted with tracing off too
    monkeypatch.undo()
    assert trace.snapshot() == before


def test_enable_and_disable_start_a_new_session_each_time():
    trace.enable()
    assert trace.on()
    with trace.span("a"):
        with trace.span("b"):
            pass
    trace.disable()
    with trace.span("c"):  # off: not recorded
        pass
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["a", "b"] and snap["steps"] == 1
    assert snap["spans"][1]["parent"] == 0 and snap["spans"][0]["parent"] == -1
    trace.enable()
    assert trace.snapshot()["spans"] == []  # a new session dropped the last one
    with trace.span("d"):
        pass
    with trace.span("d"):
        pass
    trace.disable()
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["d", "d"] and snap["steps"] == 2
    assert [s["step"] for s in snap["spans"]] == [0, 1]


def test_scan_step_records_its_phases_under_a_profiler(scan_run):
    snap, _, _ = scan_run
    spans = snap["spans"]
    assert snap["steps"] == 2
    roots = [i for i, s in enumerate(spans) if s["parent"] == -1 and s["name"] != "gc"]
    assert [spans[i]["name"] for i in roots] == ["scan.step", "scan.step"]
    names = {s["name"] for s in spans}
    assert not names & HARNESS_SPANS
    for step, root in enumerate(roots):
        kids = [s for s in spans if s["parent"] == root]
        kid_names = {s["name"] for s in kids} - {"gc"}
        want = PHASES if step == 1 else PHASES - {"scan.promote"}
        assert kid_names == want, kid_names
        r = spans[root]
        assert all(r["start_ns"] <= s["start_ns"] <= s["end_ns"] <= r["end_ns"] for s in kids)
        assert all(s["step"] == step for s in kids)
        # The phases cover the step: what is left is the frame step's pose
        # products between the phases.
        assert r["self_ns"] < 0.1 * (r["end_ns"] - r["start_ns"])
    by_index = {i: s for i, s in enumerate(spans)}
    for s in spans:
        if s["name"] in ("host_read.scan.flags", "host_read.lie.inv_lu"):
            assert by_index[s["parent"]]["name"] in ("scan.gate", "keyframe.vote", "scan.merge")
        if s["name"] == "keyframe.make":
            assert by_index[s["parent"]]["name"] == "scan.promote"
    promote = [i for i, s in enumerate(spans) if s["name"] == "scan.promote"]
    assert len(promote) == 1
    assert {s["name"] for s in spans if s["parent"] == promote[0]} - {"gc"} == {
        "keyframe.make", "tracker.track"}
    tot = snap["totals"]
    assert tot["tracker.track"]["count"] == 3 and tot["frontend.build"]["count"] == 2
    assert all(t["self_ns"] <= t["ns"] for t in tot.values())


def test_spans_lie_nested_in_the_profilers_chrome_trace(scan_run):
    snap, events, _ = scan_run
    # The collector's spans aside: where a pass starts depends on allocation.
    spans = [s for s in snap["spans"] if s["name"] != "gc"]
    # By start, a parent before a child that starts in the same microsecond.
    ours = sorted((e for e in events if e["name"] in {s["name"] for s in spans}),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    order = sorted(range(len(spans)), key=lambda i: spans[i]["start_ns"])
    assert [e["name"] for e in ours] == [spans[i]["name"] for i in order]
    at = {id(spans[i]): (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for i, e in zip(order, ours)}
    for s in spans:
        if s["parent"] >= 0:
            p0, p1 = at[id(snap["spans"][s["parent"]])]
            t0, t1 = at[id(s)]
            assert p0 <= t0 and t1 <= p1 + 1.0  # within the parent's event (us)


def test_scan_step_counts_its_host_reads_by_site(scan_run):
    snap, _, reads = scan_run
    # A step reads its flags once and takes the gate's LU once (the vote's
    # needs a full ring, which two steps do not fill).
    for site in ("scan.flags", "lie.inv_lu"):
        assert reads[site] == snap["host_reads"][site] == 2
        steps = [s["step"] for s in snap["spans"] if s["name"] == "host_read." + site]
        assert steps == [0, 1]


def test_a_collection_is_a_gc_span_outside_its_parents_self_time():
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.002)
        gc.collect()
    trace.disable()
    snap = trace.snapshot()
    outer, kids = snap["spans"][0], [s for s in snap["spans"] if s["parent"] == 0]
    assert [s["name"] for s in kids] == ["gc"]
    gc_ns = kids[0]["end_ns"] - kids[0]["start_ns"]
    assert gc_ns > 0
    assert outer["self_ns"] == outer["end_ns"] - outer["start_ns"] - gc_ns
    assert trace._gc_hook not in gc.callbacks  # the hook goes with the session


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_plain_level_hands_over_the_evaluations_solve_level_ref_counts(solver_name):
    import dataclasses

    seeds, xis, change = EXIT_CASES[solver_name]
    opt = dataclasses.replace(small_config().tracker.optimizer, solver=solver_name, **change)
    quad, cloud, R0, t0 = _seeded_lanes(seeds, xis)
    gn = solver_name == "gn_fixed"
    _, want = solver.solve_level_ref(quad, cloud, _cam(), R0, t0, opt, 0, gn)
    trace.enable()
    state = solver.level_state(quad, cloud, _cam(), R0, t0, opt, 0, gn)
    trace.disable()
    untraced = solver.level_state(quad, cloud, _cam(), R0, t0, opt, 0, gn)
    assert all(torch.equal(a, b) for a, b in zip(solver._tree_leaves(state),
                                                 solver._tree_leaves(untraced)))
    levels = trace.snapshot()["levels"]
    assert len(levels) == 1
    assert levels[0]["evaluations"] == want.tolist()
    assert levels[0]["points"] == cloud.points.shape[-2]
    assert len(set(want.tolist())) > 1


def test_level_launches_are_read_at_snapshot_with_the_kernels_counts(monkeypatch):
    k = solver.solve_level_kernel
    monkeypatch.setattr(k, "launches", k.launches)
    monkeypatch.setattr(k, "check_launches", k.check_launches)
    trace.enable()
    evals = torch.tensor([3, 5], dtype=torch.int32)
    trace.level_launch(evals, 4096)
    evals += 1  # kept by reference: read when the snapshot is taken
    trace.level_launch(torch.tensor([7], dtype=torch.int32), 1024)
    k.launches += 2
    k.check_launches += 1
    trace.disable()
    snap = trace.snapshot()
    assert snap["levels"] == [{"points": 4096, "evaluations": [4, 6]},
                              {"points": 1024, "evaluations": [7]}]
    assert snap["level_kernel"]["launches"] == 2 and snap["level_kernel"]["check_launches"] == 1
    assert trace.snapshot()["levels"] == snap["levels"]  # read once, kept


def test_trace_to_writes_the_programs_spans(tmp_path):
    cfg = small_config()
    grays, depths = _frames(cfg, 2)
    kf = frontend.make_keyframe_batched(frontend.build_frame_batched(grays[:1], depths[:1], cfg),
                                        torch.eye(4)[None], cfg)
    with utils.trace_to(str(tmp_path)):
        f = frontend.build_frame_batched(grays[1:], depths[1:], cfg)
        system.tracker.track_frames_batched(kf._replace(frame=None), f, torch.eye(3)[None],
                                            torch.zeros(1, 3), cfg)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"frontend.build", "tracker.track"} <= names
    assert trace.snapshot()["totals"]["frontend.build"]["count"] == 1


def test_keyframe_times_are_device_events_read_at_the_report(monkeypatch):
    """VOSystem times make_keyframe between two CUDA events on the card and
    reads them only in report(); no synchronise on the live path."""
    cfg = small_config()
    grays, depths = _frames(cfg, 2)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (_ for _ in ()).throw(AssertionError("synchronised")))
    vo = system.VOSystem(cfg, "cpu")
    for i in range(2):
        vo.process_frame(grays[i].numpy(), depths[i].numpy(), i / 30.0)
    assert len(vo.dt_times) == vo.n_keyframes == 1
    assert vo.report().mean_dt_time_ms == vo.keyframe_ms()[0] > 0.0

    class Event:
        made = []

        def __init__(self, enable_timing=False):
            self.t, self.waited = len(Event.made), False
            Event.made.append(self)

        def record(self):
            pass

        def synchronize(self):
            self.waited = True

        def elapsed_time(self, end):
            assert end.waited
            return 2.5 * (end.t - self.t)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    vo.device = torch.device("cuda", 0)
    vo.dt_times = [(vo._mark(), vo._mark())]
    assert not Event.made[1].waited  # recorded, not waited for
    assert vo.keyframe_ms() == [2.5]
