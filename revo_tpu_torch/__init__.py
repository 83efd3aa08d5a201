"""revo_tpu_torch — the PyTorch / CUDA port of revo_tpu.

The per-frame tracking step of revo_tpu (``frontend.build_frame`` ->
``frontend.make_keyframe`` -> ``tracker.track_frames``) and the VO loop
around it (``system.VOSystem``, ``parallel.batch.vo_scan``, ``autotune``,
``python -m revo_tpu_torch.run``) and the SLAM back end (``loopclosure``,
``parallel.posegraph``, ``parallel.windowed``, ``parallel.segments``,
``checkpoint``) and the multi-device layer (``parallel.mesh``, the mesh
forms of those modules, ``parallel.pipeline.pipeline_replay``) on torch
tensors, the host side around them (``io``: TUM files, synthetic scenes,
live sensors, recorder, native bindings; ``viz``; ``utils``), with
hand-written Hopper kernels (``csrc/*.cu``) for the three kernels the
JAX package wrote in Pallas: Canny NMS (K1) and hysteresis (K2) in
``ops.canny``, the LGSX normal-equation reduction (K3) in ``ops.lgsx``.
The main path also runs B sequences at once, each lane bit-equal to
itself alone, as the JAX package's ``vmap`` runs it
(``frontend.build_frame_batched``, ``tracker.track_frames_batched``,
``parallel.batch.vo_scan_batched``; K3 takes the lanes in one launch).
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


def __getattr__(name):
    """``pipeline_replay`` on first use (keeps ``import revo_tpu_torch``
    light, as the JAX package keeps its top-level API lazy)."""
    if name == "pipeline_replay":
        from revo_tpu_torch.parallel.pipeline import pipeline_replay

        return pipeline_replay
    raise AttributeError(f"module 'revo_tpu_torch' has no attribute {name!r}")


__all__ = [
    "CameraConfig",
    "DatasetConfig",
    "OptimizerConfig",
    "PyramidConfig",
    "SystemConfig",
    "TrackerConfig",
    "load_config",
    "pipeline_replay",
    "__version__",
]
