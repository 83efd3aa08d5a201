"""revo_tpu_torch — the PyTorch / CUDA port of revo_tpu.

The per-frame tracking step of revo_tpu (``frontend.build_frame`` ->
``frontend.make_keyframe`` -> ``tracker.track_frames``) and the VO loop
around it (``system.VOSystem``, ``parallel.batch.vo_scan``, ``autotune``,
``python -m revo_tpu_torch.run``) on torch tensors, with hand-written
Hopper kernels (``csrc/*.cu``) for the three kernels the
JAX package wrote in Pallas: Canny NMS (K1) and hysteresis (K2) in
``ops.canny``, the LGSX normal-equation reduction (K3) in ``ops.lgsx``.
Module names mirror revo_tpu's.  This package imports torch and numpy, never
jax or revo_tpu; ``revo_tpu`` stays the reference it is tested against.
"""

from revo_tpu_torch.config import (
    CameraConfig,
    DatasetConfig,
    OptimizerConfig,
    PyramidConfig,
    SystemConfig,
    TrackerConfig,
    load_config,
)

__version__ = "0.1.0"

__all__ = [
    "CameraConfig",
    "DatasetConfig",
    "OptimizerConfig",
    "PyramidConfig",
    "SystemConfig",
    "TrackerConfig",
    "load_config",
    "__version__",
]
