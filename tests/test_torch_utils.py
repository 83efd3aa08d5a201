"""The port's utility layer (revo_tpu_torch/utils) on the CPU: its exports,
the logger beside the JAX package's, ``trace_to`` writes a Chrome trace
(the tracer itself: tests/test_torch_trace.py).
"""
import json
import logging

import pytest
import torch

from revo_tpu import utils as jutils
from revo_tpu_torch import utils

torch.set_num_threads(1)


def test_exports_match_jax():
    """The port's own exports: the logger (its levels the JAX package's),
    ``trace_to`` and the tracer."""
    assert sorted(utils.__all__) == ["LEVELS", "get_logger", "set_level", "trace", "trace_to"]
    assert all(hasattr(utils, name) for name in utils.__all__)
    assert utils.trace_to is utils.trace.trace_to and callable(utils.trace.span)
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
