"""Separable filters: Gaussian blur, pyramid downsampling, Sobel
(counterpart of revo_tpu/ops/filters.py).

Shifted adds over a REFLECT_101-padded image (torch's ``"reflect"`` pad mode
is OpenCV's BORDER_REFLECT_101).  On uint8-valued float32 input ``pyr_down``
and ``sobel`` are exact in float32 (taps are k/16 and small integers), so
their results do not depend on the summation order.

``pyramid`` is the frame's pyramid, gray and depth together: CPU tensors
take ``pyramid_ref`` (``pyr_level_ref``, that is ``pyr_down`` and
``ops.depth.subsample_depth_with_holes``, a step at a time); CUDA tensors
the hand kernel ``revo_pyramid`` (csrc/frontend.cu), one launch for two
steps of all lanes, bit-equal to it and counted in ``pyramid.launches``.
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
    float32: one step of ``pyramid_ref``."""
    g, d = _as_float(gray, depth, inv_scale)
    return pyr_down(g), subsample_depth_with_holes(d)


def pyramid_ref(gray: torch.Tensor, depth: torch.Tensor, inv_scale: float = 1.0,
                n_levels: int = 3):
    """(B, H, W) gray and depth as ``pyr_level_ref`` takes them -> a list of
    ``n_levels`` (gray, depth) float32 pairs: the input as float32
    (``_as_float``), then ``pyr_level_ref`` a step: the plain version of
    ``pyramid``."""
    levels = [_as_float(gray, depth, inv_scale)]
    for _ in range(n_levels - 1):
        levels.append(pyr_level_ref(*levels[-1]))
    return levels


def pyramid(gray: torch.Tensor, depth: torch.Tensor, inv_scale: float = 1.0, n_levels: int = 3):
    """``pyramid_ref``, bit-equal: every level a tensor of its own.  CUDA
    tensors: ``revo_pyramid``, one launch for two steps of all B lanes (a
    further launch for each two more levels), which from uint8 gray / uint16
    depth also writes level 0's float32 (a float32 input is level 0 as it
    is); uint8 or float32 gray, uint16 or float32 depth, each step's input
    at least 3 x 3, as REFLECT_101 needs."""
    if gray.dim() != 3 or gray.shape != depth.shape or n_levels < 1:
        raise ValueError(f"pyramid: want (B, H, W) gray and depth of one shape and n_levels >= 1, "
                         f"got {tuple(gray.shape)}, {tuple(depth.shape)}, {n_levels}")
    b, h, w = gray.shape
    sizes = [(h, w)]
    for _ in range(n_levels - 1):
        if min(sizes[-1]) < 3:
            raise ValueError(f"pyramid: want every step's input at least 3x3, got levels {sizes}")
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    if not kernels.on_card("pyramid", gray, depth):
        return pyramid_ref(gray, depth, inv_scale, n_levels)
    if gray.dtype not in (torch.uint8, torch.float32) or depth.dtype not in (
            torch.uint16, torch.float32):
        raise ValueError(f"pyramid: want uint8 / float32 gray and uint16 / float32 depth, "
                         f"got {gray.dtype}, {depth.dtype}")
    if n_levels == 1:
        return [_as_float(gray, depth, inv_scale)]
    gray, depth = gray.contiguous(), depth.contiguous()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=gray.device)

    g0 = gray if gray.dtype == torch.float32 else empty(b, h, w)
    d0 = depth if depth.dtype == torch.float32 else empty(b, h, w)
    levels = [(g0, d0)]
    g_in, d_in = gray, depth
    while len(levels) < n_levels:  # gray halves rounding up, depth rounding down
        steps = min(2, n_levels - len(levels))
        (hh, ww), (hd, wd) = g_in.shape[1:], d_in.shape[1:]
        outs = []
        for _ in range(steps):
            hh, ww, hd, wd = (hh + 1) // 2, (ww + 1) // 2, hd // 2, wd // 2
            outs.append((empty(b, hh, ww), empty(b, hd, wd)))
        first = len(levels) == 1
        g2, d2 = outs[1] if steps == 2 else (None, None)
        kernels.launch("revo_pyramid", g_in, int(g_in.dtype == torch.uint8), d_in,
                       int(d_in.dtype == torch.uint16), inv_scale,
                       g0 if first and g0 is not gray else None,
                       d0 if first and d0 is not depth else None,
                       *outs[0], g2, d2, b, *g_in.shape[1:], *d_in.shape[1:], steps)
        pyramid.launches += 1
        levels += outs
        g_in, d_in = outs[-1]
    return levels


pyramid.launches = 0
