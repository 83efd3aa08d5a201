"""Rigid transform and pinhole projection of an edge cloud, with the
roundings of the jitted JAX expressions (revo_tpu/solver.py
``_apply_rt_cols`` and ``u = x / z * fx + cx``).  Shared by the residual
pass (ops/lgsx.py), the solver's cost-only evaluation and the tracker's
voting.
"""
from __future__ import annotations

import numpy as np
import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, like the fused multiply-add that
    jitted XLA emits on the CPU (and ``__fmaf_rn`` on the card).  Taken in
    float64, where the product of two float32 values is exact; the float64
    sum and the float32 rounding disagree with one rounding only where the
    exact sum lies within 2^-29 of a float32 tie."""
    return (a.double() * b.double() + c.double()).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's and numpy's.  CUDA's
    ``sqrtf`` is IEEE already; PyTorch's CPU kernel is not (on an AVX-512
    host about one float32 integer in five below 2^22 comes out an ulp
    off), so a CPU tensor goes through float64, whose square root of a
    float32 value rounds to the correctly rounded float32 one."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def apply_rt_cols(pts, R, t):
    """(R @ p + t) for (..., P, 3) points as (x, y, z) columns, (...) the
    lanes of R (..., 3, 3) and t (..., 3), rounded as jitted XLA on the CPU
    rounds the JAX expression ``R00 x + R01 y + R02 z + t0``
    (revo_tpu/solver.py ``_apply_rt_cols``): the second product is rounded
    to float32, the first and third are fused multiply-adds onto it, and
    the translation is a plain add; never a (possibly TF32) matmul.  The
    residual pass, the cost-only evaluation and windowed BA's pair pass
    hold bounds, floor() and bilinear weights against the JAX package to
    the last bit with it."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    def row(r):
        acc = R[..., r, 1, None] * y
        acc = fma_f32(R[..., r, 0, None], x, acc)
        acc = fma_f32(R[..., r, 2, None], z, acc)
        return acc + t[..., r, None]

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
