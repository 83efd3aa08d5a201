"""Trajectory evaluation (numpy)."""
from revo_tpu_torch.eval.ate import (
    ATEResult,
    RPEResult,
    absolute_trajectory_error,
    relative_pose_error,
)

__all__ = ["ATEResult", "RPEResult", "absolute_trajectory_error", "relative_pose_error"]
