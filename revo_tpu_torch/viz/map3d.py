"""Live 3-D map rendering: keyframe frusta + decimated colored point
cloud under a camera-follow projection — the headless equivalent of the
reference's MapDrawer (gui/MapDrawer.cc:48-180: DrawMapPoints /
DrawKeyFrames / camera-follow in Viewer.cc).  Pure NumPy + matplotlib
(host side, render thread only; copy of revo_tpu/viz/map3d.py).
"""
from __future__ import annotations

import numpy as np

# Virtual follow-camera intrinsics (render target 640x480).
_F, _CX, _CY, _W, _H = 420.0, 320.0, 240.0, 640, 480


def _follow_view(T_w_cam: np.ndarray) -> np.ndarray:
    """World-from-view pose of the follow camera: behind and above the
    current camera, pitched down slightly (the MapDrawer follow mode)."""
    off = np.eye(4, dtype=np.float64)
    off[:3, 3] = [0.0, -0.45, -1.8]  # up + back in the camera frame
    pitch = 0.22
    c, s = np.cos(pitch), np.sin(pitch)
    rot = np.eye(4)
    rot[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return T_w_cam.astype(np.float64) @ off @ rot


def _project(V_inv: np.ndarray, pts_w: np.ndarray):
    """Project world points through the follow camera; returns (u, v, z)."""
    p = pts_w @ V_inv[:3, :3].T + V_inv[:3, 3]
    z = p[:, 2]
    safe = np.where(np.abs(z) < 1e-6, 1e-6, z)
    u = p[:, 0] / safe * _F + _CX
    v = p[:, 1] / safe * _F + _CY
    return u, v, z


def _frustum_corners(T_w_k: np.ndarray, scale: float = 0.12) -> np.ndarray:
    """5 corners of a camera frustum glyph (apex + 4 image corners) in
    world coordinates (MapDrawer::DrawKeyFrames geometry)."""
    w, h, zf = 0.8 * scale, 0.6 * scale, 1.0 * scale
    local = np.array(
        [
            [0.0, 0.0, 0.0],
            [-w, -h, zf],
            [w, -h, zf],
            [w, h, zf],
            [-w, h, zf],
        ]
    )
    return local @ T_w_k[:3, :3].T + T_w_k[:3, 3]


_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4),
                  (4, 1)]


def render_map_png(
    out_png: str,
    clouds,
    kf_poses,
    traj: np.ndarray,
    follow_T: np.ndarray,
    title: str = "",
) -> None:
    """Render the map view to ``out_png``.

    clouds: list of (pts_world (M, 3), colors (M, 3) in [0, 1]).
    kf_poses: (K, 4, 4) keyframe world poses (frusta).
    traj: (N, 4, 4) trajectory poses (polyline).
    follow_T: (4, 4) current camera pose the view follows.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    V_inv = np.linalg.inv(_follow_view(follow_T))
    fig, ax = plt.subplots(figsize=(6.4, 4.8), dpi=100)
    ax.set_facecolor("#101010")
    fig.patch.set_facecolor("#101010")

    if clouds:
        pts = np.concatenate([c[0] for c in clouds])
        cols = np.concatenate([c[1] for c in clouds])
        u, v, z = _project(V_inv, pts)
        ok = (z > 0.05) & (u > -50) & (u < _W + 50) & (v > -50) & (v < _H + 50)
        if ok.any():
            order = np.argsort(-z[ok])  # far first (cheap painter's order)
            ax.scatter(
                u[ok][order], v[ok][order],
                c=np.clip(cols[ok][order], 0, 1),
                s=np.clip(140.0 / np.maximum(z[ok][order], 0.2), 0.3, 6.0),
                marker=".", linewidths=0,
            )

    def draw_frustum(T, color, lw):
        cw = _frustum_corners(np.asarray(T, np.float64))
        u, v, z = _project(V_inv, cw)
        if (z <= 0.05).any():
            return
        for a, b in _FRUSTUM_EDGES:
            ax.plot([u[a], u[b]], [v[a], v[b]], color=color, lw=lw)

    for T in np.asarray(kf_poses):
        draw_frustum(T, "#4da6ff", 0.8)
    if len(traj):
        u, v, z = _project(V_inv, np.asarray(traj)[:, :3, 3])
        ok = z > 0.05
        ax.plot(u[ok], v[ok], color="#7CFF6B", lw=1.0, alpha=0.9)
    draw_frustum(follow_T, "#ff5050", 1.6)  # current camera, highlighted

    ax.set_xlim(0, _W)
    ax.set_ylim(_H, 0)  # image coords: y down
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_title(title, color="#dddddd", fontsize=9)
    fig.tight_layout(pad=0.3)
    fig.savefig(out_png)
    plt.close(fig)
