"""Trajectory evaluation (numpy)."""
from revo_tpu_torch.eval.ate import ATEResult, absolute_trajectory_error

__all__ = ["ATEResult", "absolute_trajectory_error"]
