"""Rigid transform and pinhole projection of an edge cloud, with the
roundings of the jitted JAX expressions (revo_tpu/solver.py
``_apply_rt_cols`` and ``u = x / z * fx + cx``).  Shared by the residual
pass (ops/lgsx.py), the solver's cost-only evaluation and the tracker's
voting.
"""
from __future__ import annotations

import numpy as np
import torch


def apply_rt_cols(pts, R, t):
    """(R @ p + t) for (P, 3) points as (x, y, z) columns: nine float32
    multiply-adds per point, never a (possibly TF32) matmul."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    wx = R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z + t[..., 0]
    wy = R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z + t[..., 1]
    wz = R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z + t[..., 2]
    return wx, wy, wz


def _f32(x: float) -> float:
    return float(np.float32(x))


def scale_shift(q: torch.Tensor, scale: float, shift: float) -> torch.Tensor:
    """float32 ``q * scale + shift`` rounded once, like the fused
    multiply-add XLA emits for the JAX expression.  The projection
    ``u = x / z * fx + cx`` lands on integer pixel coordinates at the
    identity pose, where floor() and the ``u > 1`` bound are knife edges, so
    the rounding must match.  The float64 product of two float32 values is
    exact; the float64 sum and the final float32 rounding disagree with a
    single rounding only on exact ties."""
    return (q.to(torch.float64) * _f32(scale) + _f32(shift)).to(torch.float32)
