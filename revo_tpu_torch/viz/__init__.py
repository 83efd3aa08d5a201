"""Map and trajectory export (counterpart of revo_tpu/viz, PLY part)."""
from revo_tpu_torch.viz.ply import (
    export_colored_pcl_ply,
    export_keyframe_frusta_ply,
    export_trajectory_ply,
)

__all__ = [
    "export_colored_pcl_ply",
    "export_keyframe_frusta_ply",
    "export_trajectory_ply",
]
