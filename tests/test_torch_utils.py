"""The port's utility layer (revo_tpu_torch/utils) beside the JAX package's
on the CPU: the logger, ``MetricsRecorder`` and ``StageTimes`` behave alike,
``Timer`` and ``StageTimes.stage`` take an explicit device and touch CUDA
only for a CUDA device, ``trace_to`` writes a Chrome trace.
"""
import json
import logging
import time

import pytest
import torch

from revo_tpu import utils as jutils
from revo_tpu_torch import utils
from revo_tpu_torch.utils import timing

torch.set_num_threads(1)


def test_exports_match_jax():
    assert sorted(utils.__all__) == sorted(jutils.__all__)
    assert utils.LEVELS == jutils.LEVELS


def test_logger_name_levels_and_threshold(capsys):
    from revo_tpu_torch.utils import logging as tlogging

    # Configure afresh, so the handler writes to the stderr this test captures.
    root = logging.getLogger("revo_tpu_torch")
    for handler in list(root.handlers):
        root.removeHandler(handler)
    tlogging._configured = False
    log = utils.get_logger("revo_tpu_torch.test")
    assert log.name == "revo_tpu_torch.test" and utils.get_logger().name == "revo_tpu_torch"
    assert root.propagate is False and len(root.handlers) == 1
    utils.get_logger("revo_tpu_torch.again")
    assert len(root.handlers) == 1  # configured once
    assert logging.getLevelName(5) == "TRACE" and logging.getLevelName(8) == "DETAIL"
    try:
        utils.set_level("warning")
        log.info("hidden")
        log.warning("shown")
        utils.set_level("trace")
        log.log(utils.LEVELS["trace"], "traced")
        utils.set_level("nothing")
        log.critical("silenced")
    finally:
        utils.set_level("info")
    err = capsys.readouterr().err
    assert "[WARNING] revo_tpu_torch.test: shown" in err and "[TRACE]" in err
    assert "hidden" not in err and "silenced" not in err and "\x1b[" not in err  # no tty, no colour
    # The JAX package's logger is a separate tree with its own threshold.
    assert logging.getLogger("revo_tpu").level != utils.LEVELS["nothing"]
    with pytest.raises(KeyError):
        utils.set_level("loud")


def test_metrics_recorder_matches_jax(tmp_path):
    rows = [dict(frame=0, error=0.5, good=100, status="ok"),
            dict(frame=1, error=0.25, good=80),
            dict(frame=2, error=1.0, note=None)]
    mt, mj = utils.MetricsRecorder(), jutils.MetricsRecorder()
    assert mt.summary() == mj.summary() == {}
    for row in rows:
        mt.record(**row)
        mj.record(**row)
    assert mt.summary() == mj.summary()
    assert mt.summary()["error_max"] == 1.0 and mt.summary()["n_frames"] == 3
    mt.dump_jsonl(str(tmp_path / "t.jsonl"))
    mj.dump_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()] == rows


def test_stage_times_matches_jax():
    st, sj = utils.StageTimes(), jutils.StageTimes()
    for s in (st, sj):
        s.add("dt", 2.0)
        s.add("dt", 4.0)
        s.add("track", 10.0)
    assert st.report() == sj.report() == {"dt": 3.0, "track": 10.0}
    assert st.mean("missing") == sj.mean("missing") == 0.0
    with st.stage("sleep", device="cpu"):
        time.sleep(0.01)
    with st.stage("host"):
        pass
    assert 10.0 <= st.mean("sleep") < 1000.0 and 0.0 <= st.mean("host") < 10.0


def test_timer_on_the_cpu_never_touches_cuda(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA was touched for a CPU device")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    with utils.Timer(device="cpu") as t:
        time.sleep(0.005)
    assert 5.0 <= t.ms < 1000.0
    with utils.Timer(device="cuda", sync=False) as t:
        pass
    assert t.ms >= 0.0
    with utils.StageTimes().stage("x", device=torch.device("cpu")):
        pass


def test_timer_on_cuda_synchronizes_and_does_not_swallow(monkeypatch):
    """A CUDA device is synchronized (the named one), and a synchronize
    that fails raises: no try / except hides a lost device."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: seen.append(d))
    with utils.Timer(device="cuda:0"):
        pass
    with utils.StageTimes().stage("x", device="cuda:0"):
        pass
    assert seen == [torch.device("cuda:0")] * 2

    def lost(d=None):
        raise RuntimeError("device lost")

    monkeypatch.setattr(torch.cuda, "synchronize", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        with utils.Timer():  # the default device is the card
            pass
    with pytest.raises(RuntimeError, match="device lost"):
        timing._synchronize("cuda")


def test_trace_to_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with utils.trace_to(str(log_dir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n or "matmul" in n for n in names)
    with utils.trace_to(None):  # no directory, no trace, no error
        pass
    assert sorted(p.name for p in log_dir.iterdir()) == ["trace.json"]
