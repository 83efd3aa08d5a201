"""Utility layer: logging and the tracer (counterpart of revo_tpu/utils).

Replaces the reference's utils/ (Logging.h I3D_LOG macro logger, timer.h
Timer) with a Python logger and ``trace``, the port's spans and counters
inside the step, which ``trace_to`` writes out with a profiler's trace.
"""

from revo_tpu_torch.utils import trace
from revo_tpu_torch.utils.logging import get_logger, set_level, LEVELS
from revo_tpu_torch.utils.trace import trace_to

__all__ = [
    "get_logger",
    "set_level",
    "LEVELS",
    "trace_to",
    "trace",
]
