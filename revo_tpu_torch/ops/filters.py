"""Separable filters: Gaussian blur, pyramid downsampling, Sobel
(counterpart of revo_tpu/ops/filters.py).

Shifted adds over a REFLECT_101-padded image (torch's ``"reflect"`` pad mode
is OpenCV's BORDER_REFLECT_101).  On uint8-valued float32 input ``pyr_down``
and ``sobel`` are exact in float32 (taps are k/16 and small integers), so
their results do not depend on the summation order.

``pyr_level`` is one step of the frame's pyramid, gray and depth together:
a CPU tensor takes ``pyr_level_ref`` (``pyr_down`` and
``ops.depth.subsample_depth_with_holes``); a CUDA tensor the hand kernel
``revo_pyr_level`` (csrc/frontend.cu), one launch for all lanes, bit-equal
to it and counted in ``pyr_level.launches``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from revo_tpu_torch import kernels
from revo_tpu_torch.ops.depth import subsample_depth_with_holes


def _reflect_pad(img: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """REFLECT_101 pad of (..., H, W) by ry rows and rx columns."""
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    x = F.pad(x, (rx, rx, ry, ry), mode="reflect")
    return x.reshape(*lead, *x.shape[-2:])


def _sep_filter(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2-D correlation with REFLECT_101 borders on (..., H, W):
    rows with ``kx``, then columns with ``ky``, each tap added in order
    (the JAX module's order)."""
    nx, ny = len(kx), len(ky)
    rx, ry = nx // 2, ny // 2
    x = _reflect_pad(img, ry, rx)
    h, w = img.shape[-2:]
    row = None
    for j in range(nx):
        term = x[..., :, j:j + w] * float(kx[j])
        row = term if row is None else row + term
    out = None
    for i in range(ny):
        term = row[..., i:i + h, :] * float(ky[i])
        out = term if out is None else out + term
    return out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: sampled Gaussian, normalized to sum 1."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(
    img: torch.Tensor, ksize: int = 7, sigma: float = 2.0, quantize: bool = True
) -> torch.Tensor:
    """cv::GaussianBlur(gray, 7x7, 2), rounded to integer levels when
    ``quantize`` (uint8 semantics of the reference pipeline)."""
    k = gaussian_kernel(ksize, sigma)
    out = _sep_filter(img.to(torch.float32), k, k)
    return torch.round(out) if quantize else out


_PYR_K = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def pyr_down(img: torch.Tensor, quantize: bool = True) -> torch.Tensor:
    """cv::pyrDown: 5-tap [1,4,6,4,1]/16 blur, samples at even coordinates.
    Output is ((H+1)//2, (W+1)//2); rounds half to even like jnp.round."""
    out = _sep_filter(img.to(torch.float32), _PYR_K, _PYR_K)[..., ::2, ::2]
    out = out.contiguous()
    return torch.round(out) if quantize else out


_SOBEL_D = (-1.0, 0.0, 1.0)
_SOBEL_S = (1.0, 2.0, 1.0)


def sobel(img: torch.Tensor):
    """3x3 Sobel derivatives (gx, gy) with REFLECT_101 borders; exact on
    integer-valued input (cv::Sobel(src, CV_16S, ksize=3))."""
    x = img.to(torch.float32)
    return _sep_filter(x, _SOBEL_D, _SOBEL_S), _sep_filter(x, _SOBEL_S, _SOBEL_D)


def _as_float(gray: torch.Tensor, depth: torch.Tensor, inv_scale: float):
    """Gray as float32; uint16 raw depth times ``inv_scale`` (the front
    end's conversion), float32 depth as it is."""
    if depth.dtype == torch.uint16:
        depth = depth.to(torch.float32) * inv_scale
    return gray.to(torch.float32), depth


def pyr_level_ref(gray: torch.Tensor, depth: torch.Tensor, inv_scale: float = 1.0):
    """(B, H, W) gray (uint8 or uint8-valued float32) and depth (float32
    metres, or uint16 raw times ``inv_scale``) -> the next pyramid level:
    (pyr_down gray (B, (H+1)//2, (W+1)//2), hole-aware depth (B, H//2, W//2)),
    float32: the plain version of ``pyr_level``."""
    g, d = _as_float(gray, depth, inv_scale)
    return pyr_down(g), subsample_depth_with_holes(d)


def pyr_level(gray: torch.Tensor, depth: torch.Tensor, inv_scale: float = 1.0):
    """``pyr_level_ref``, bit-equal.  CUDA tensors: ``revo_pyr_level``, one
    launch for all B lanes (uint8 or float32 gray, uint16 or float32 depth,
    H and W at least 3, as REFLECT_101 needs)."""
    if gray.dim() != 3 or gray.shape != depth.shape:
        raise ValueError(f"pyr_level: want (B, H, W) gray and depth of one shape, got "
                         f"{tuple(gray.shape)}, {tuple(depth.shape)}")
    if not kernels.on_card("pyr_level", gray, depth):
        return pyr_level_ref(gray, depth, inv_scale)
    b, h, w = gray.shape
    if min(h, w) < 3:
        raise ValueError(f"pyr_level: want H, W >= 3, got {h}x{w}")
    if gray.dtype not in (torch.uint8, torch.float32) or depth.dtype not in (
            torch.uint16, torch.float32):
        raise ValueError(f"pyr_level: want uint8 / float32 gray and uint16 / float32 depth, "
                         f"got {gray.dtype}, {depth.dtype}")
    gray, depth = gray.contiguous(), depth.contiguous()
    g_out = torch.empty((b, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=gray.device)
    d_out = torch.empty((b, h // 2, w // 2), dtype=torch.float32, device=gray.device)
    kernels.launch("revo_pyr_level", gray, int(gray.dtype == torch.uint8), depth,
                   int(depth.dtype == torch.uint16), inv_scale, g_out, d_out, b, h, w)
    pyr_level.launches += 1
    return g_out, d_out


pyr_level.launches = 0
