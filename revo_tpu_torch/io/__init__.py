"""Host-side IO: dataset parsing, synthetic scenes, native prefetch, live
sensors and recorded captures (counterpart of revo_tpu/io)."""

from revo_tpu_torch.io.synthetic import SyntheticScene, render_frame
from revo_tpu_torch.io.tum import (
    load_associations,
    load_tum_frame,
    write_tum_trajectory,
    read_tum_trajectory,
)

__all__ = [
    "SyntheticScene",
    "render_frame",
    "load_associations",
    "load_tum_frame",
    "write_tum_trajectory",
    "read_tum_trajectory",
]
