"""Structured per-frame metrics (replaces the reference's log-scraping; copy
of revo_tpu/utils/metrics.py).

The reference reports residual statistics through ResidualInfo logging
(optimizer.h:118-140) and an end-of-run VO report (system.cpp:292-304); here
each frame appends a dict and the recorder can summarize or dump JSONL.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List


class MetricsRecorder:
    def __init__(self):
        self.frames: List[Dict[str, Any]] = []

    def record(self, **kwargs) -> None:
        self.frames.append(dict(kwargs))

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if not self.frames:
            return out
        keys = {
            k for f in self.frames for k, v in f.items()
            if isinstance(v, (int, float))
        }
        for k in keys:
            vals = [f[k] for f in self.frames if k in f]
            out[f"{k}_mean"] = sum(vals) / len(vals)
            out[f"{k}_max"] = max(vals)
        out["n_frames"] = len(self.frames)
        return out

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.frames:
                f.write(json.dumps(row) + "\n")
