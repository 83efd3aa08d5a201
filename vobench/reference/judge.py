"""The numbers that decide ``correct``: what the program produced against
what the reference works out from the same rendered frames.  Each is a
largest gap (or share) over every judged answer, and passes when it is at
or under its limit (``vobench/limits/<workload>.json``).

- ``gray``: largest gap of a pyramid level's gray (levels are integers);
- ``depth_m``: largest gap of a pyramid level's depth (metres);
- ``edges``: largest share, over judged frames and levels, of edge pixels
  (before and after the fill-in) that differ, per reference edge pixel;
- ``cloud_m``: largest gap of an edge-cloud slot's point (a slot valid on
  one side only reads as the valid point's size);
- ``kf_table``: largest gap of a keyframe's structure (gx, gy, dt) or quad
  table entry (pixels);
- ``cost_gap``: the largest amount by which a tracked pose's objective (the
  mean Huber-weighted squared residual of the finest level, in squared
  pixels, worked out by the reference against its own tables and cloud)
  lies above that of the reference's own pose: the pose's counterpart of a
  served token's logit below the reference's best; ``cost_share`` the share
  of the scan's sampled lane-steps whose amount passes ``COST_TAU``;
- ``flags``: answers whose promoted or lost flag differs.

Poses are judged by their objective and not by their distance from the
reference's: where Levenberg-Marquardt stops on a flat stretch of its
objective, float32 and float64 stop apart at the same cost.
"""
from __future__ import annotations

import torch


def _max(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def frames_gap(prog: list, ref: list) -> dict:
    """Front-end numbers of batched level dicts (the same frames, lane by
    lane)."""
    gray = depth = cloud = edges = 0.0
    for p, r in zip(prog, ref):
        gray = max(gray, _max(p["gray"].double() - r["gray"].double()))
        depth = max(depth, _max(p["depth"].double() - r["depth"].double()))
        n_ref = r["edges"].flatten(1).sum(1).clamp(min=1).double()
        bad = ((p["edges"] != r["edges"]).flatten(1).sum(1)
               + (p["edges_orig"] != r["edges_orig"]).flatten(1).sum(1)).double()
        edges = max(edges, float((bad / n_ref).max()))
        pp = torch.where(p["valid"][..., None], p["points"].double(), 0.0)
        rp = torch.where(r["valid"][..., None], r["points"].double(), 0.0)
        cloud = max(cloud, _max(pp - rp))
    return {"gray": gray, "depth_m": depth, "edges": edges, "cloud_m": cloud}


def tables_gap(prog: list, ref: list) -> float:
    """Keyframe number of per-level (structure, quad table) pairs."""
    gap = 0.0
    for (ps, pq), (rs, rq) in zip(prog, ref):
        gap = max(gap, _max(ps.double() - rs.double()), _max(pq.double() - rq.double()))
    return gap


def cost_gap(c_prog: torch.Tensor, c_ref: torch.Tensor) -> float:
    """The largest c_prog - c_ref; a non-finite cost reads as infinitely
    far."""
    if not c_prog.numel():
        return 0.0
    excess = c_prog.double() - c_ref.double()
    excess = torch.where(torch.isfinite(excess), excess, torch.full_like(excess, float("inf")))
    return float(excess.max())


COST_TAU = 0.01  # px^2: sound samples read ~1e-6, a 1 cm pose error 0.05 or more


def cost_share(c_prog: torch.Tensor, c_ref: torch.Tensor, tau: float = COST_TAU) -> float:
    """Share of answers whose objective lies more than ``tau`` above the
    reference pose's (a non-finite one counts)."""
    if not c_prog.numel():
        return 0.0
    excess = c_prog.double() - c_ref.double()
    return float((~(excess <= tau)).double().mean())


def checks(numbers: dict, limits: dict) -> dict:
    """Each number the cell compares (those with a limit) beside its limit."""
    return {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
