"""PLY model export (a copy of revo_tpu/viz/ply.py, numpy only), mirroring
REVOGui::MapDrawer::saveModel
(gui/MapDrawer.h:97-170): an ascii colored point cloud ('outputPcl.ply'
layout) and a keyframe-frusta wireframe with trajectory edges
('outputKf.ply' layout: 5 vertices + 9 edges per camera, blue frusta, green
inter-camera links)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def export_colored_pcl_ply(path: str, points_xyz: np.ndarray,
                           colors_rgb01: np.ndarray) -> None:
    """Ascii PLY of colored points; colors in [0,1] like the reference's
    generateColoredPcl output (imgpyramidrgbd.cpp:279-327)."""
    pts = np.asarray(points_xyz, dtype=np.float32).reshape(-1, 3)
    clr = np.asarray(colors_rgb01, dtype=np.float32).reshape(-1, 3)
    assert len(pts) == len(clr)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write(
            "property float32 x\nproperty float32 y\nproperty float32 z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        c255 = np.clip(clr * 255.0, 0, 255).astype(np.uint8)
        for p, c in zip(pts, c255):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def export_keyframe_frusta_ply(
    path: str, kf_poses: Sequence[np.ndarray], frustum_w: float = 0.1
) -> None:
    """Keyframe frusta + trajectory edges, exactly the reference's layout:
    per camera 5 vertices (center + 4 image-plane corners at w x 0.75w,
    depth 0.6w) and 9 edges (8 frustum, 1 link to the previous camera)."""
    w = frustum_w
    h = w * 0.75
    z = w * 0.6
    corners = np.array(
        [[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]], np.float32
    )
    n = len(kf_poses)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n * 5}\n")
        f.write(
            "property float32 x\nproperty float32 y\nproperty float32 z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        )
        f.write(f"element edge {max(n * 9 - 1, 0)}\n")
        f.write(
            "property int vertex1\nproperty int vertex2\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for T in kf_poses:
            R = np.asarray(T)[:3, :3]
            t = np.asarray(T)[:3, 3]
            f.write(f"{t[0]} {t[1]} {t[2]} 0 0 255\n")
            for c in corners:
                p = R @ c + t
                f.write(f"{p[0]} {p[1]} {p[2]} 0 0 255\n")
        for i in range(n):
            cc, p1, p2, p3, p4 = (i * 5 + k for k in range(5))
            for a, b in [(cc, p1), (cc, p2), (cc, p3), (cc, p4),
                         (p1, p4), (p1, p2), (p2, p3), (p3, p4)]:
                f.write(f"{a} {b} 0 0 255\n")
            if i > 0:
                f.write(f"{(i - 1) * 5} {cc} 0 255 0\n")


def export_trajectory_ply(path: str, poses: np.ndarray) -> None:
    """Trajectory polyline (MapDrawer.cc:118-138 drawn live; exported here)."""
    t = np.asarray(poses)[:, :3, 3]
    n = len(t)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write(
            "property float32 x\nproperty float32 y\nproperty float32 z\n"
        )
        f.write(f"element edge {max(n - 1, 0)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p in t:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for i in range(n - 1):
            f.write(f"{i} {i + 1}\n")
