"""The comparison that decides ``correct`` against a broken timed path: the
harness's look for a card is skipped, a run is driven at 160x120 on the
CPU with the cell's own limits, and each fault the cells can have makes
``correct`` false: a step that returns its state unchanged, half of the
batch left out (the mean of the rest in its place), and the poses altered
where the tracker produces them.  One chip runs each cell, so no exchange
between chips exists to leave out."""
from __future__ import annotations

import pytest
import torch

from vobench import harness
from vobench.tests._tiny import tiny_cell


def _unchanged_track(real):
    def track(kf, frame, R0, t0, cfg):
        res = real(kf, frame, R0, t0, cfg)
        return res._replace(R=R0.clone(), t=t0.clone())
    return track


def _half_batch(real):
    def track(kf, frame, R0, t0, cfg):
        res = real(kf, frame, R0, t0, cfg)
        h = max(res.R.shape[0] // 2, 1)
        R, t = res.R.clone(), res.t.clone()
        R[h:], t[h:] = res.R[:h].mean(0), res.t[:h].mean(0)
        return res._replace(R=R, t=t)
    return track


def _altered(real):
    def track(kf, frame, R0, t0, cfg):
        res = real(kf, frame, R0, t0, cfg)
        return res._replace(t=res.t + torch.tensor([0.01, 0.0, 0.0]))
    return track


def _unchanged_scan(real):
    def step(states, gray, depth, cfg):
        _, out = real(states, gray, depth, cfg)
        return states, out._replace(T_w=torch.stack([s.prev_T_w for s in states]))
    return step


CASES = [("tum_fr1.track_chain", "tracker", "track_frames_batched", _unchanged_track),
         ("tum_fr1.track_chain", "tracker", "track_frames_batched", _half_batch),
         ("tum_fr1.track_chain", "tracker", "track_frames_batched", _altered),
         ("tum_fr1.scan_desk", "batch", "_vo_scan_step_batched", _unchanged_scan),
         ("tum_fr1.scan_desk", "tracker", "track_frames_batched", _half_batch),
         ("tum_fr1.scan_desk", "tracker", "track_frames_batched", _altered)]


@pytest.mark.parametrize("workload,module,name,fault", CASES,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, _, _, f in CASES])
def test_fault_reads_not_correct(monkeypatch, workload, module, name, fault):
    from revo_tpu_torch import tracker
    from revo_tpu_torch.parallel import batch

    mod = {"tracker": tracker, "batch": batch}[module]
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    cell = tiny_cell(workload, lanes=4)
    line = harness.run_cell(cell, 4242, 12.0, False, torch.device("cpu"))
    assert line["attempted"] > 0, "the window completed no step"
    assert line["correct"] is False, (line["attempted"], line["checks"])
    assert [k for k, c in line["checks"].items() if c["value"] > c["limit"]], line["checks"]


def test_sound_scan_reads_correct():
    """Without a fault the scan reads ``correct`` true: the mirror carries
    each lane's state as the scan does."""
    line = harness.run_cell(tiny_cell("tum_fr1.scan_desk", lanes=4), 4243, 12.0, False,
                            torch.device("cpu"))
    assert line["attempted"] > 0, "the window completed no step"
    assert line["correct"] is True, line["checks"]
