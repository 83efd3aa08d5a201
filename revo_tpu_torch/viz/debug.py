"""Per-frame reprojection debug overlay (counterpart of revo_tpu/viz/debug.py).

Replaces the reference's DO_SHOW_DEBUG_IMAGE path (reprojectPCLToImg,
system.cpp:307-333; drawing in tracker.cpp:24-106, debug PNG dumps
tracker.cpp:188-199): the current frame's edge cloud is transformed by the
estimated pose and splatted onto the KEYFRAME's gray image, colored by the
DT residual at the landing point (green = on an edge, red = far).  The
drawing is host-side NumPy; ``overlay_inputs`` is the one place that reads
tensors (from any device), so a caller on another thread can be handed
arrays only.  Returns an (H, W, 3) uint8 image and optionally writes a PNG.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _host(x) -> np.ndarray:
    """numpy view of an array or of a tensor on any device."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def keyframe_inputs(kf, lvl: int = 0):
    """Host copies of what the overlay reads from a keyframe: (gray uint8
    (H, W), dt float32 (H, W))."""
    gray = _host(kf.frame.levels[lvl].gray).astype(np.uint8)
    return gray, _host(kf.structs[lvl][..., 2])


def frame_inputs(frame, lvl: int = 0):
    """Host copies of what the overlay reads from a frame: its level-``lvl``
    edge cloud as (points (P, 3), valid (P,))."""
    cloud = frame.levels[lvl].cloud
    return _host(cloud.points), _host(cloud.valid)


def overlay_from_arrays(gray, dt, pts, valid, R, t, cam,
                        out_png: Optional[str] = None) -> np.ndarray:
    """The overlay from host arrays (``keyframe_inputs``, ``frame_inputs``)
    and the level's camera."""
    Rn = np.asarray(R, dtype=np.float32)
    tn = np.asarray(t, dtype=np.float32)
    wxp = pts @ Rn.T + tn
    z = np.where(wxp[:, 2] == 0, 1e-12, wxp[:, 2])
    u = wxp[:, 0] / z * cam.fx + cam.cx
    v = wxp[:, 1] / z * cam.fy + cam.cy
    h, w = gray.shape
    ok = valid & (u >= 0) & (v >= 0) & (u < w - 1) & (v < h - 1) & (z > 0)
    ui = u[ok].astype(np.int32)
    vi = v[ok].astype(np.int32)
    r = dt[vi, ui]

    img = np.stack([gray, gray, gray], axis=-1)
    # Residual color ramp: green (0 px) -> yellow -> red (>= 5 px).
    s = np.clip(r / 5.0, 0.0, 1.0)
    img[vi, ui, 0] = (255 * s).astype(np.uint8)
    img[vi, ui, 1] = (255 * (1.0 - 0.5 * s)).astype(np.uint8)
    img[vi, ui, 2] = 0
    if out_png is not None:
        try:
            import cv2

            cv2.imwrite(out_png, img[..., ::-1])  # BGR on disk
        except ImportError:
            pass
    return img


def reprojection_overlay(
    kf,
    frame,
    R,
    t,
    cfg,
    lvl: int = 0,
    out_png: Optional[str] = None,
) -> np.ndarray:
    """Overlay ``frame``'s level-``lvl`` edge cloud, warped by (R, t), onto
    the keyframe's gray image; color encodes the keyframe-DT residual."""
    return overlay_from_arrays(
        *keyframe_inputs(kf, lvl), *frame_inputs(frame, lvl), _host(R), _host(t),
        cfg.camera_pyramid()[lvl], out_png,
    )
