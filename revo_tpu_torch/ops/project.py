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
    """(R @ p + t) for (..., P, 3) points as (x, y, z) columns, (...) the
    lanes of R (..., 3, 3) and t (..., 3): nine float32 multiply-adds per
    point, never a (possibly TF32) matmul."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    def row(r):
        return (R[..., r, 0, None] * x + R[..., r, 1, None] * y + R[..., r, 2, None] * z
                + t[..., r, None])

    return row(0), row(1), row(2)


def apply_rt_cols_fma(pts, R, t):
    """``apply_rt_cols`` rounded as jitted XLA on the CPU rounds the JAX
    expression ``R00 x + R01 y + R02 z + t0``: the second product is rounded
    to float32, the first and third are fused multiply-adds onto it, and the
    translation is a plain add.  Each FMA is taken in float64 (the product
    of two float32 values is exact there), so the result is the same on
    every device.  For passes that hold bounds and bilinear weights against
    the JAX package to the last bit, where ``apply_rt_cols``' separately
    rounded products differ by an ulp in one coordinate of eight."""
    x, y, z = (pts[..., k].double() for k in range(3))
    Rd = R.double()

    def row(r):
        acc = (Rd[..., r, 1] * y).float()
        acc = (Rd[..., r, 0] * x + acc.double()).float()
        acc = (Rd[..., r, 2] * z + acc.double()).float()
        return acc + t[..., r]

    return row(0), row(1), row(2)


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
