"""ATE / RPE (numpy copy of revo_tpu/eval/ate.py).

ATE: rigidly align the estimated to the ground-truth translations (Horn,
rotation + translation, no scale) and report the translational RMSE, as TUM
evaluate_ate.py does.  RPE: per-pair relative-motion error over a fixed
frame delta, translational and rotational RMSE (TUM evaluate_rpe.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    aligned_est: np.ndarray  # (N, 3) aligned estimated translations


def _horn_align(est: np.ndarray, gt: np.ndarray):
    """Least-squares rigid alignment est -> gt (closed form via SVD)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    W = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    return R, mu_g - R @ mu_e


def absolute_trajectory_error(est_poses: np.ndarray, gt_poses: np.ndarray) -> ATEResult:
    """ATE-RMSE between (N, 4, 4) estimated and ground-truth poses,
    associated 1:1."""
    est_t = est_poses[:, :3, 3]
    gt_t = gt_poses[:, :3, 3]
    R, t = _horn_align(est_t, gt_t)
    aligned = est_t @ R.T + t
    err = np.linalg.norm(aligned - gt_t, axis=1)
    return ATEResult(
        rmse=float(np.sqrt((err ** 2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        aligned_est=aligned,
    )


class RPEResult(NamedTuple):
    trans_rmse: float
    rot_rmse_deg: float


def relative_pose_error(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> RPEResult:
    """RPE over frame pairs (i, i+delta): error of the relative motion
    E = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d})."""
    terrs, rerrs = [], []
    for i in range(len(est_poses) - delta):
        dq = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        dp = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        e = np.linalg.inv(dq) @ dp
        terrs.append(np.linalg.norm(e[:3, 3]))
        cos_a = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.degrees(np.arccos(cos_a)))
    terrs = np.array(terrs)
    rerrs = np.array(rerrs)
    return RPEResult(
        trans_rmse=float(np.sqrt((terrs ** 2).mean())),
        rot_rmse_deg=float(np.sqrt((rerrs ** 2).mean())),
    )
