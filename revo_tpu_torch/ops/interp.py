"""Bilinear sampling at float pixel coordinates (counterpart of
revo_tpu/ops/interp.py): ``bilinear_sample_dtquad`` of the dt-only quad table
the tracker's solver reads (non-lane path), and ``bilinear_sample`` of an
(H, W, C) image, which windowed BA and undistortion read.

Coordinates are floored like the reference's int cast
(optimizer.h:173-185); callers mask lanes outside 1 < u < W-2, 1 < v < H-2
(optimizer.cpp:100), and indices are clamped here only to stay in memory.
"""
from __future__ import annotations

import torch


def bilinear_sample_dtquad(
    quad: torch.Tensor, u: torch.Tensor, v: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """(H*W, 4) dt taps sampled at (u, v) (N,) -> (N, 3) (gx, gy, dt).

    dt is the reference's 4-tap bilinear formula; gx, gy are the analytic
    derivatives of that bilinear surface, negated to the keyframe
    structure's sign convention (imgpyramidrgbd.cpp:267-274):
        gx = -(dy (i11 - i10) + (1 - dy)(i01 - i00))
        gy = -(dx (i11 - i01) + (1 - dx)(i10 - i00))
    """
    fu, fv = torch.floor(u), torch.floor(v)
    dx = (u - fu)[:, None]
    dy = (v - fv)[:, None]
    # Clamp in float first: the int cast of a huge or NaN coordinate is
    # undefined, and such lanes are masked by the caller anyway.
    ix = torch.nan_to_num(fu, nan=0.0).clamp(0, w - 2).to(torch.int64)
    iy = torch.nan_to_num(fv, nan=0.0).clamp(0, h - 2).to(torch.int64)
    q = quad[iy * w + ix]
    if q.dtype != u.dtype:
        q = q.to(u.dtype)  # bf16 storage upcasts after the gather
    i00, i01, i10, i11 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    dxdy = dx * dy
    dt_s = (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )
    gx = -(dy * (i11 - i10) + (1.0 - dy) * (i01 - i00))
    gy = -(dx * (i11 - i01) + (1.0 - dx) * (i10 - i00))
    return torch.cat([gx, gy, dt_s], dim=-1)


def bilinear_sample_stacked(
    stack: torch.Tensor, index: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Sample image ``index`` of an (S, H, W, C) stack at (u, v); ``index``,
    ``u`` and ``v`` share (or broadcast to) one shape (...), the result is
    (..., C).  One gather per tap over the flattened stack: the batched form
    of ``bilinear_sample`` (JAX vmaps it over the pair axis).  Weights are
    the reference's 4-tap formula (optimizer.h:173-185):
        out = dxdy I[iy+1, ix+1] + (dy - dxdy) I[iy+1, ix]
            + (dx - dxdy) I[iy, ix+1] + (1 - dx - dy + dxdy) I[iy, ix]
    """
    h, w = stack.shape[1], stack.shape[2]
    fu, fv = torch.floor(u), torch.floor(v)
    dx = (u - fu)[..., None]
    dy = (v - fv)[..., None]
    # Clamp in float first: the int cast of a huge or NaN coordinate is
    # undefined, and such lanes are masked by the caller anyway.
    ix = torch.nan_to_num(fu, nan=0.0).clamp(0, w - 2).to(torch.int64)
    iy = torch.nan_to_num(fv, nan=0.0).clamp(0, h - 2).to(torch.int64)
    flat = stack.reshape(-1, stack.shape[-1])
    base = index.to(torch.int64) * (h * w) + iy * w + ix
    i00, i01, i10, i11 = flat[base], flat[base + 1], flat[base + w], flat[base + w + 1]
    dxdy = dx * dy
    # The four-term sum rounds as jitted XLA on the CPU rounds it: the
    # second product to float32, the others fused multiply-adds onto it in
    # order, each taken in float64 (float32 products are exact there), so
    # the result is the same on every device.  Undistortion rounds the
    # sample to a gray level, where an ulp decides a .5 tie.
    acc = ((dy - dxdy).double() * i10.double()).float()
    for weight, tap in ((dxdy, i11), (dx - dxdy, i01), (1.0 - dx - dy + dxdy, i00)):
        acc = (weight.double() * tap.double() + acc.double()).float()
    return acc


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) image at float pixel coordinates (u, v) of shape
    (N,); returns (N, C)."""
    return bilinear_sample_stacked(img[None], torch.zeros_like(u, dtype=torch.int64), u, v)
