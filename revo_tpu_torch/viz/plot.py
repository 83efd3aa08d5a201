"""Offline trajectory/map rendering to PNG (matplotlib, host-side; copy of
revo_tpu/viz/plot.py).

The reference's live Pangolin viewer (gui/Viewer.cc) draws keyframe frusta,
the trajectory polyline and the current camera; this module renders the
same content offline — trajectory top-down + 3D, estimated-vs-ground-truth
overlays, and an ATE error plot — for headless runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(
    path: str,
    poses: np.ndarray,
    gt_poses: Optional[np.ndarray] = None,
    title: str = "trajectory",
) -> None:
    """Write a 2-panel PNG: top-down (x-z) path and per-axis translation."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray(poses)[:, :3, 3]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
    ax1.plot(t[:, 0], t[:, 2], "b-", label="estimate")
    ax1.plot(t[0, 0], t[0, 2], "go", label="start")
    if gt_poses is not None:
        g = np.asarray(gt_poses)[:, :3, 3]
        ax1.plot(g[:, 0], g[:, 2], "k--", alpha=0.6, label="ground truth")
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("z [m]")
    ax1.axis("equal")
    ax1.legend()
    ax1.set_title(title)

    for i, name in enumerate("xyz"):
        ax2.plot(t[:, i], label=f"{name} est")
        if gt_poses is not None:
            ax2.plot(np.asarray(gt_poses)[:, i, 3], "--", alpha=0.6,
                     label=f"{name} gt")
    ax2.set_xlabel("frame")
    ax2.set_ylabel("translation [m]")
    ax2.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_error(path: str, poses: np.ndarray, gt_poses: np.ndarray) -> None:
    """Per-frame translation error after Horn alignment + RMSE line."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from revo_tpu_torch.eval import absolute_trajectory_error

    ate = absolute_trajectory_error(np.asarray(poses), np.asarray(gt_poses))
    err = np.linalg.norm(
        ate.aligned_est - np.asarray(gt_poses)[:, :3, 3], axis=1
    )
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(err * 100.0)
    ax.axhline(ate.rmse * 100.0, color="r", linestyle="--",
               label=f"ATE-RMSE {ate.rmse * 100:.2f} cm")
    ax.set_xlabel("frame")
    ax.set_ylabel("error [cm]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
