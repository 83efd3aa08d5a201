"""Utility layer: logging, timing, metrics, profiling (counterpart of
revo_tpu/utils).

Replaces the reference's utils/ (Logging.h I3D_LOG macro logger, timer.h
Timer) with Python equivalents plus structured per-frame metrics instead of
log-scraping.
"""

from revo_tpu_torch.utils.logging import get_logger, set_level, LEVELS
from revo_tpu_torch.utils.timing import Timer, StageTimes, trace_to
from revo_tpu_torch.utils.metrics import MetricsRecorder

__all__ = [
    "get_logger",
    "set_level",
    "LEVELS",
    "Timer",
    "StageTimes",
    "trace_to",
    "MetricsRecorder",
]
