"""Offline visualization and model export (counterpart of revo_tpu/viz;
replaces the reference's Pangolin GUI layer): PLY exporters, matplotlib
trajectory and error plots, the reprojection overlay.  ``viz.live`` and
``viz.map3d`` hold the during-run viewer."""
from revo_tpu_torch.viz.ply import (
    export_colored_pcl_ply,
    export_keyframe_frusta_ply,
    export_trajectory_ply,
)
from revo_tpu_torch.viz.plot import plot_error, plot_trajectory
from revo_tpu_torch.viz.debug import reprojection_overlay

__all__ = [
    "export_colored_pcl_ply",
    "export_keyframe_frusta_ply",
    "export_trajectory_ply",
    "plot_error",
    "plot_trajectory",
    "reprojection_overlay",
]
