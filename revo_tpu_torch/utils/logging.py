"""Leveled, colored logging with parity to the reference's I3D_LOG (copy of
revo_tpu/utils/logging.py under the logger name ``revo_tpu_torch``).

The reference (utils/Logging.h:119-129) defines 8 levels
(trace/detail/debug/info/warning/error/fatal/nothing) with ANSI colors
(Logging.h:108-115), a runtime threshold (Logging.cpp:111) and atomic
per-line output.  Here: a thin wrapper over ``logging`` with the same level
names, a global runtime threshold, and color when attached to a tty.
"""
from __future__ import annotations

import logging
import sys

# Reference level ordering (Logging.h:119-129): higher = more severe.
LEVELS = {
    "trace": 5,
    "detail": 8,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "nothing": logging.CRITICAL + 10,
}

_COLORS = {
    "debug": "\x1b[36m",
    "info": "\x1b[32m",
    "warning": "\x1b[33m",
    "error": "\x1b[31m",
    "fatal": "\x1b[35m",
}
_RESET = "\x1b[0m"

logging.addLevelName(5, "TRACE")
logging.addLevelName(8, "DETAIL")


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname.lower(), "")
            if color:
                return f"{color}{msg}{_RESET}"
        return msg


_configured = False


def get_logger(name: str = "revo_tpu_torch") -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _ColorFormatter("[%(levelname)s] %(name)s: %(message)s")
        )
        root = logging.getLogger("revo_tpu_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logger


def set_level(level: str) -> None:
    """Runtime threshold, like LOG_THRESHOLD (Logging.h:183)."""
    logging.getLogger("revo_tpu_torch").setLevel(LEVELS[level])
