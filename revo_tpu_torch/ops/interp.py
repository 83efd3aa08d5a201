"""Bilinear sampling at float pixel coordinates (counterpart of
revo_tpu/ops/interp.py): the samplers of the tracker's residual pass, one
per table layout the solver reads (``sample_table``: the dt-only quad table,
the 12-component quad table and the (H, W, 3) structure), and
``bilinear_sample`` of an (H, W, C) image, which windowed BA and
undistortion read.

Coordinates are floored like the reference's int cast
(optimizer.h:173-185); callers mask lanes outside 1 < u < W-2, 1 < v < H-2
(optimizer.cpp:100), and indices are clamped here only to stay in memory.

Every sum of products rounds as jitted XLA on the CPU rounds the JAX
expression: the second product to float32, the others fused multiply-adds
onto it in order (``project.fma_f32``), so the samples equal the JAX
package's bit for bit on every device.  The CUDA kernel
(revo_tpu_torch/csrc/lgsx.cu) does the same with ``__fmaf_rn``.
"""
from __future__ import annotations

import torch

from revo_tpu_torch.ops.project import fma_f32


def _taps_at(u: torch.Tensor, v: torch.Tensor, h: int, w: int):
    """(row index of the top-left tap (...,) int64, dx, dy (..., 1)): the
    floor of (u, v) clamped to [0, w-2] x [0, h-2] and its fractions."""
    fu, fv = torch.floor(u), torch.floor(v)
    dx = (u - fu)[..., None]
    dy = (v - fv)[..., None]
    # Clamp in float first: the int cast of a huge or NaN coordinate is
    # undefined, and such lanes are masked by the caller anyway.
    ix = torch.nan_to_num(fu, nan=0.0).clamp(0, w - 2).to(torch.int64)
    iy = torch.nan_to_num(fv, nan=0.0).clamp(0, h - 2).to(torch.int64)
    return iy * w + ix, dx, dy


def _bilinear(i00, i01, i10, i11, dx, dy):
    """The reference's 4-tap formula (optimizer.h:173-185)
        dxdy I11 + (dy - dxdy) I10 + (dx - dxdy) I01 + (1 - dx - dy + dxdy) I00
    with the second product rounded and the others fused onto it."""
    dxdy = dx * dy
    acc = (dy - dxdy) * i10
    acc = fma_f32(dxdy, i11, acc)
    acc = fma_f32(dx - dxdy, i01, acc)
    return fma_f32(1.0 - dx - dy + dxdy, i00, acc)


def _upcast(q: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return q if q.dtype == like.dtype else q.to(like.dtype)  # bf16 tables upcast after the gather


def bilinear_sample_dtquad(
    quad: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(H*W, 4) dt taps [dt(y, x), dt(y, x+1), dt(y+1, x), dt(y+1, x+1)]
    sampled at (u, v) (N,) -> (N, 3) (gx, gy, dt) (revo_tpu/ops/interp.py
    ``bilinear_sample_dtquad``).

    dt is the reference's 4-tap bilinear formula; gx, gy are the analytic
    derivatives of that bilinear surface, negated to the keyframe
    structure's sign convention (imgpyramidrgbd.cpp:267-274):
        gx = -(dy (i11 - i10) + (1 - dy)(i01 - i00))
        gy = -(dx (i11 - i01) + (1 - dx)(i10 - i00))
    """
    base, dx, dy = _taps_at(u, v, h, w)
    q = _upcast(quad[base], u)
    i00, i01, i10, i11 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    dt_s = _bilinear(i00, i01, i10, i11, dx, dy)
    gx = -fma_f32(dy, i11 - i10, (1.0 - dy) * (i01 - i00))
    gy = -fma_f32(dx, i11 - i01, (1.0 - dx) * (i10 - i00))
    return torch.cat([gx, gy, dt_s], dim=-1)


def bilinear_sample_quad(
    quad: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(H*W, 12) quad table, rows [S(y, x), S(y, x+1), S(y+1, x),
    S(y+1, x+1)] of the (gx, gy, dt) structure S (float32, or bfloat16 for
    "flatbf"), sampled at (u, v) (N,) -> (N, 3): one row gather a point and
    the 4-tap formula per channel (revo_tpu/ops/interp.py
    ``bilinear_sample_quad``), the reference's interpolated central
    differences.  The same bits as ``bilinear_sample`` of the structure."""
    base, dx, dy = _taps_at(u, v, h, w)
    q = _upcast(quad[base], u)
    return _bilinear(q[:, 0:3], q[:, 3:6], q[:, 6:9], q[:, 9:12], dx, dy)


def bilinear_sample_rows(
    rows: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """An (H, W, C) image as (H*W, C) rows sampled at (u, v) (N,) -> (N, C):
    four row gathers, the 4-tap formula per channel (revo_tpu/ops/interp.py
    ``bilinear_sample``, the "take4" form)."""
    base, dx, dy = _taps_at(u, v, h, w)
    return _bilinear(rows[base], rows[base + 1], rows[base + w], rows[base + w + 1], dx, dy)


def sample_table(table: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: int, w: int
                 ) -> torch.Tensor:
    """(gx, gy, dt) (N, 3) at (u, v) from a keyframe level's table as the
    solver holds it, (H*W, C) rows, the sampler picked by the row width as
    revo_tpu/solver.py ``_sample_quad`` and ``_BILINEAR`` pick it: C = 4 the
    dt-only quad table ("dt4" / "dt4bf"), C = 12 the 12-component quad
    table ("hw12", "flat", "t", "flat16", "flatbf"), C = 3 the float32
    structure itself (a ``bilinear_impl`` that is not "quad*")."""
    c = table.shape[-1]
    if c == 4:
        return bilinear_sample_dtquad(table, u, v, h, w)
    if c == 12:
        return bilinear_sample_quad(table, u, v, h, w)
    if c == 3:
        return bilinear_sample_rows(table, u, v, h, w)
    raise ValueError(f"no sampler for table rows of width {c} (want 3, 4 or 12)")


def bilinear_sample_stacked(
    stack: torch.Tensor, index: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Sample image ``index`` of an (S, H, W, C) stack at (u, v); ``index``,
    ``u`` and ``v`` share (or broadcast to) one shape (...), the result is
    (..., C).  One gather per tap over the flattened stack: the batched form
    of ``bilinear_sample`` (JAX vmaps it over the pair axis).  Undistortion
    rounds the sample to a gray level, where an ulp decides a .5 tie."""
    h, w = stack.shape[1], stack.shape[2]
    base, dx, dy = _taps_at(u, v, h, w)
    flat = stack.reshape(-1, stack.shape[-1])
    base = index.to(torch.int64) * (h * w) + base
    return _bilinear(flat[base], flat[base + 1], flat[base + w], flat[base + w + 1], dx, dy)


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) image at float pixel coordinates (u, v) of shape
    (N,); returns (N, C)."""
    return bilinear_sample_rows(img.reshape(-1, img.shape[-1]), u, v, img.shape[0], img.shape[1])
