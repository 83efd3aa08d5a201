"""The program's own spans and counters (``revo_tpu_torch.utils.trace``) as
the per-layer readers take them.  The program traces while a profiler
records, so the tracer's last session is the run's traced segment; the
readers divide by the segment's steps, ``obs["trace"]["steps"]``.

``session(obs)`` is None where the run traced nothing on the device, the
program has no tracer, or the session recorded no step: the reader then
returns None and the metric is left out."""
from __future__ import annotations


def session(obs):
    tr = obs.get("trace")
    if not tr or not tr.get("steps"):
        return None
    try:
        from revo_tpu_torch.utils import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap.get("steps") else None


def ms_per_step(obs, snap, names, key: str = "self_ns") -> float:
    """The spans ``names``' time a step in ms: ``self_ns`` (less what their
    children, the collector's passes included, cover) or ``ns`` (whole)."""
    totals = snap["totals"]
    return sum(totals[n][key] for n in names if n in totals) * 1e-6 / obs["trace"]["steps"]
