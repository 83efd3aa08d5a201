"""Separable filters: Gaussian blur, pyramid downsampling, Sobel
(counterpart of revo_tpu/ops/filters.py).

Shifted adds over a REFLECT_101-padded image (torch's ``"reflect"`` pad mode
is OpenCV's BORDER_REFLECT_101).  On uint8-valued float32 input ``pyr_down``
and ``sobel`` are exact in float32 (taps are k/16 and small integers), so
their results do not depend on the summation order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
