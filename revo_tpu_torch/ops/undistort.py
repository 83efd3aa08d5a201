"""Undistort-rectify maps and the per-frame remap (counterpart of
revo_tpu/ops/undistort.py).

Replaces the reference's OpenCV undistortion (camerapyr.h:125-137:
initUndistortRectifyMap; imgpyramidrgbd.cpp:57-65: cv::remap with
CV_INTER_LINEAR on gray and depth).  The maps are built once on the host in
numpy float64 with the radial-tangential (k1, k2, p1, p2, k3) model; the
remap is a bilinear warp on the device of the image.

The rectified camera matrix is the original K (the reference feeds
getOptimalNewCameraMatrix alpha=0, but its shipped configs leave
DO_UNDISTORT off; keeping K avoids the crop heuristic and stays exact
w.r.t. cv2.initUndistortRectifyMap(K, dist, I, K, ...)).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from revo_tpu_torch.config import CameraConfig
from revo_tpu_torch.ops.interp import bilinear_sample


def build_undistort_maps(cam: CameraConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(map_u, map_v) float32 (H, W): source coordinates of each rectified
    pixel.  Per destination pixel: the normalized ray through K^-1, the
    distortion model, re-projection with K, which is what
    cv::initUndistortRectifyMap computes with newCameraMatrix == K."""
    k1, k2, p1, p2, k3 = cam.distortion
    u, v = np.meshgrid(
        np.arange(cam.width, dtype=np.float64),
        np.arange(cam.height, dtype=np.float64),
    )
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_u = (x_d * cam.fx + cam.cx).astype(np.float32)
    map_v = (y_d * cam.fy + cam.cy).astype(np.float32)
    return map_u, map_v


def remap_bilinear(img: torch.Tensor, map_u: torch.Tensor, map_v: torch.Tensor) -> torch.Tensor:
    """Bilinear warp: out[y, x] = img(map_v[y, x], map_u[y, x]); samples out
    of range clamp to the border (cv::remap BORDER_CONSTANT differs only on
    pixels the solver's 2-px border test excludes anyway)."""
    h, w = img.shape
    u = map_u.reshape(-1).clamp(0.0, w - 1.001)
    v = map_v.reshape(-1).clamp(0.0, h - 1.001)
    out = bilinear_sample(img[..., None].to(torch.float32), u, v)
    return out[:, 0].reshape(h, w)
