"""Canny edges: K1 (Sobel + NMS + double threshold) and K2 (hysteresis).

Counterpart of revo_tpu/ops/canny.py and of the two Pallas kernels
revo_tpu/ops/pallas/canny_kernel.py (``_nms_core`` via ``_canny_single`` /
``_nms_batched``) and revo_tpu/ops/pallas/hysteresis.py (``_fixpoint`` via
``_run_batched``).  cv::Canny(gray, 150, 100, apertureSize=3,
L2gradient=true) semantics, as called by the reference
(imgpyramidrgbd.cpp:105-108).

Each kernel has a plain PyTorch version beside it (``canny_nms_ref``,
``hysteresis_ref``).  A wrapper runs the plain version for a tensor on the
CPU and the CUDA kernel (revo_tpu_torch/csrc/canny.cu) for a tensor on the
card; for any other tensor it raises.  ``launches`` on each wrapper counts
its kernel launches.  K2 has two kernels, chosen by image shape
(``hysteresis_fits_shared``).

Sector test: the Pallas form ``ay > ax * f32(tan22.5 + 2)`` (the constant
folded in double, then rounded to f32), where revo_tpu/ops/canny.py writes
``tg22x + 2 * ax``.  For every integer gradient pair a Sobel of uint8 input
can give (|g| <= 1020) the two forms agree (checked exhaustively), so the
edges are bit-equal to both JAX paths.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from revo_tpu_torch import kernels
from revo_tpu_torch.ops.filters import _reflect_pad

_TAN22 = 0.4142135623730950488  # tan(pi/8)
_TG22 = float(torch.tensor(_TAN22, dtype=torch.float32))
_TG67 = float(torch.tensor(_TAN22 + 2.0, dtype=torch.float32))
_UNROLL = 8  # dilation steps per fixpoint trip (hysteresis.py:27)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], zero outside."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = x[
        ..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)
    ]
    return out


def canny_nms_ref(gray_pad: torch.Tensor, low_sq: float, high_sq: float):
    """Plain K1.  (B, H+2, W+2) REFLECT_101-padded uint8-valued float32 gray
    -> (cand, strong) (B, H, W) bool.

    Sobel gx/gy, squared-L2 magnitude, sector by |gy| against |gx| tan22.5
    and |gx| tan67.5 (sign of gx*gy picks the diagonal), NMS with OpenCV's
    asymmetry (``>`` then ``>=`` on horizontal/vertical, strict on the
    diagonals; magnitude 0 outside the image), then cand = keep & mag > low^2
    and strong = cand & mag > high^2 (canny_kernel.py:39-95)."""
    g = gray_pad
    hh, ww = g.shape[-2] - 2, g.shape[-1] - 2

    def at(dy, dx):
        return g[..., 1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]

    gx = (at(-1, 1) + 2.0 * at(0, 1) + at(1, 1)) - (
        at(-1, -1) + 2.0 * at(0, -1) + at(1, -1)
    )
    gy = (at(1, -1) + 2.0 * at(1, 0) + at(1, 1)) - (
        at(-1, -1) + 2.0 * at(-1, 0) + at(-1, 1)
    )
    mag = gx * gx + gy * gy
    ax, ay = gx.abs(), gy.abs()
    horiz = ay < ax * _TG22
    vert = ay > ax * _TG67
    diag_pos = (gx * gy) >= 0

    keep_h = (mag > _shift(mag, 0, -1)) & (mag >= _shift(mag, 0, 1))
    keep_v = (mag > _shift(mag, -1, 0)) & (mag >= _shift(mag, 1, 0))
    keep_dp = (mag > _shift(mag, -1, -1)) & (mag > _shift(mag, 1, 1))
    keep_dn = (mag > _shift(mag, -1, 1)) & (mag > _shift(mag, 1, -1))
    keep = torch.where(
        horiz, keep_h,
        torch.where(vert, keep_v, torch.where(diag_pos, keep_dp, keep_dn)),
    )
    cand = keep & (mag > low_sq)
    return cand, cand & (mag > high_sq)


def hysteresis_steps_ref(cand: torch.Tensor, strong: torch.Tensor):
    """Plain K2 and the work it took.  (B, H, W) bool -> ((B, H, W) bool
    reach, dilation steps the loop ran for the image that ran longest).

    Strong seeds grow through cand by synchronous 8-connected 3x3 dilation,
    in trips of 8 steps; an image stops after a trip that left its pixel sum
    unchanged, or once H+W steps have run (the JAX loop's cap,
    hysteresis.py:61-83), whichever comes first."""
    h, w = cand.shape[-2:]
    candf = cand.to(torch.float32)
    reach = strong.to(torch.float32)
    prev = torch.full(reach.shape[:-2], -1.0, device=reach.device)
    it = 0
    while it < h + w:
        total = reach.sum(dim=(-2, -1))
        active = total != prev
        if not bool(active.any()):
            break
        grown = reach
        for _ in range(_UNROLL):
            dil = F.max_pool2d(grown[:, None], 3, stride=1, padding=1)[:, 0]
            grown = torch.maximum(grown, candf * dil)
        reach = torch.where(active[:, None, None], grown, reach)
        prev = total
        it += _UNROLL
    return reach > 0.5, it


def hysteresis_ref(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """Plain K2.  (B, H, W) bool -> (B, H, W) bool reach."""
    return hysteresis_steps_ref(cand, strong)[0]


def _check_cuda(x: torch.Tensor, dtype, ndim: int, name: str):
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} of rank {ndim}, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def canny_nms(gray_pad: torch.Tensor, low_sq: float, high_sq: float):
    """K1 wrapper: (B, H+2, W+2) float32 padded gray -> (cand, strong)
    (B, H, W) bool.  CPU tensor: plain version; CUDA tensor: the kernel."""
    if gray_pad.device.type == "cpu":
        return canny_nms_ref(gray_pad, low_sq, high_sq)
    if gray_pad.device.type != "cuda":
        raise ValueError(f"canny_nms: unsupported device {gray_pad.device}")
    _check_cuda(gray_pad, torch.float32, 3, "canny_nms")
    b, hp, wp = gray_pad.shape
    cand = torch.empty((b, hp - 2, wp - 2), dtype=torch.bool, device=gray_pad.device)
    strong = torch.empty_like(cand)
    kernels.launch(
        "revo_canny_nms",
        gray_pad, cand, strong, b, hp - 2, wp - 2, float(low_sq), float(high_sq),
    )
    canny_nms.launches += 1
    return cand, strong


canny_nms.launches = 0


@functools.lru_cache(maxsize=None)
def _shared_limit(device: torch.device) -> int:
    """Dynamic shared memory in bytes one block may use on ``device``, as
    the CUDA runtime gives it (232448 on an H100)."""
    limit = kernels.call("revo_canny_hysteresis_shared_limit", device=device)
    if limit <= 0:
        raise RuntimeError(f"canny_hysteresis: no shared-memory limit for {device}")
    return limit


def hysteresis_fits_shared(device, h: int, w: int) -> bool:
    """Whether an (h, w) image takes K2's shared-memory kernel on
    ``device``: cand and the two state masks, one bit a pixel in rows of
    whole 32-bit words, must fit in one block's shared memory
    (3 * h * ceil(w / 32) * 4 bytes: 640x480 needs 115200 and 1024x576
    221184 of an H100's 232448; 1280x720 needs 345600 and does not fit)."""
    return 3 * h * (-(-w // 32)) * 4 <= _shared_limit(torch.device(device))


def canny_hysteresis(cand: torch.Tensor, strong: torch.Tensor, _form=None) -> torch.Tensor:
    """K2 wrapper: (B, H, W) bool cand/strong -> (B, H, W) bool edges.
    CPU tensor: plain version; CUDA tensor: the kernel, on bit-packed masks
    in shared memory where the image fits there (``hysteresis_fits_shared``:
    every pyramid level of a 640x480 frame), else on byte masks in global
    memory.  The form follows from the shape and the device alone, before
    the launch, and both give the same bits.  ``_form`` ("shared",
    "global") lets a comparison force one; "shared" raises for an image
    that does not fit."""
    if cand.device.type == "cpu":
        return hysteresis_ref(cand, strong)
    if cand.device.type != "cuda":
        raise ValueError(f"canny_hysteresis: unsupported device {cand.device}")
    _check_cuda(cand, torch.bool, 3, "canny_hysteresis")
    _check_cuda(strong, torch.bool, 3, "canny_hysteresis")
    if strong.shape != cand.shape or strong.device != cand.device:
        raise ValueError("canny_hysteresis: cand and strong differ in shape/device")
    b, h, w = cand.shape
    fits = hysteresis_fits_shared(cand.device, h, w)
    if _form not in (None, "shared", "global") or (_form == "shared" and not fits):
        raise ValueError(f"canny_hysteresis: form {_form!r} not available for {h}x{w}")
    out = torch.empty_like(cand)
    if _form == "shared" or (_form is None and fits):
        kernels.launch("revo_canny_hysteresis", cand, strong, out, b, h, w, h + w)
    else:
        tmp = torch.empty_like(cand)
        kernels.launch("revo_canny_hysteresis_global", cand, strong, out, tmp, b, h, w, h + w)
    canny_hysteresis.launches += 1
    return out


canny_hysteresis.launches = 0


def canny_batched(
    gray: torch.Tensor, threshold1: float = 150.0, threshold2: float = 100.0
) -> torch.Tensor:
    """(B, H, W) uint8-valued gray -> (B, H, W) bool edges.  As cv::Canny,
    the smaller threshold is the low (hysteresis) one."""
    low = float(min(threshold1, threshold2))
    high = float(max(threshold1, threshold2))
    gp = _reflect_pad(gray.to(torch.float32), 1, 1).contiguous()
    cand, strong = canny_nms(gp, low * low, high * high)
    return canny_hysteresis(cand, strong)


def canny(
    gray: torch.Tensor, threshold1: float = 150.0, threshold2: float = 100.0
) -> torch.Tensor:
    """(H, W) uint8-valued gray -> (H, W) bool edges."""
    return canny_batched(gray[None], threshold1, threshold2)[0]
