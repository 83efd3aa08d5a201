"""TUM RGB-D dataset IO: associate parsing, image loading, pose files (copy
of revo_tpu/io/tum.py).

``associate.txt`` lines are "rgbTs rgbPath depthTs depthPath"
(iowrapperRGBD.cpp:257-333); depth PNGs are 16-bit, scaled by
DEPTH_SCALE_FACTOR (5000 for TUM).  Pose files follow REVO::writePose
(system.cpp:76-80): ``timestamp tx ty tz qx qy qz qw``.  OpenCV is imported
only by the two frame loaders.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from revo_tpu_torch import lie


class Association(NamedTuple):
    rgb_ts: float
    rgb_path: str
    depth_ts: float
    depth_path: str


def load_associations(
    dataset_dir: str,
    associate_file: str = "associate.txt",
    skip_first: int = 0,
    max_frames: int | None = None,
) -> List[Association]:
    """Parse associate.txt (iowrapperRGBD.cpp:301-333); '#' lines skipped."""
    out: List[Association] = []
    with open(os.path.join(dataset_dir, associate_file)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 4:
                continue
            out.append(Association(float(parts[0]), parts[1], float(parts[2]), parts[3]))
    out = out[skip_first:]
    if max_frames is not None:
        out = out[:max_frames]
    return out


def load_tum_frame(
    dataset_dir: str, assoc: Association, depth_scale: float = 5000.0
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Load one (gray f32, depth f32 metres, timestamp) frame: rgb to gray
    with OpenCV's weights, 16-bit depth scaled by 1/DEPTH_SCALE_FACTOR
    (iowrapperRGBD.cpp:325-327)."""
    import cv2  # host-side decode only; never on the device path

    rgb = cv2.imread(os.path.join(dataset_dir, assoc.rgb_path))
    depth_raw = cv2.imread(os.path.join(dataset_dir, assoc.depth_path), cv2.IMREAD_UNCHANGED)
    if rgb is None or depth_raw is None:
        raise FileNotFoundError(
            f"missing {assoc.rgb_path} / {assoc.depth_path} in {dataset_dir}"
        )
    gray = cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY).astype(np.float32)
    depth = depth_raw.astype(np.float32) / depth_scale
    return gray, depth, assoc.rgb_ts


def load_tum_frame_raw(dataset_dir: str, assoc: Association) -> Tuple[np.ndarray, np.ndarray, float]:
    """Load one (gray uint8, depth uint16 raw, timestamp) frame, as the JAX
    package's native loader delivers frames (revo_tpu/io/native_loader.py):
    the compact dtypes go to the device, and build_frame converts them there
    (depth scaled by the float32 reciprocal of DEPTH_SCALE_FACTOR)."""
    import cv2  # host-side decode only; never on the device path

    rgb = cv2.imread(os.path.join(dataset_dir, assoc.rgb_path))
    depth = cv2.imread(os.path.join(dataset_dir, assoc.depth_path), cv2.IMREAD_UNCHANGED)
    if rgb is None or depth is None:
        raise FileNotFoundError(
            f"missing {assoc.rgb_path} / {assoc.depth_path} in {dataset_dir}"
        )
    return cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY), depth.astype(np.uint16), assoc.rgb_ts


def write_tum_trajectory(path: str, timestamps, translations, quaternions_xyzw) -> None:
    """Write a TUM pose file: 'ts tx ty tz qx qy qz qw' with 9 decimals,
    exactly like REVO::writePose (system.cpp:76-80)."""
    with open(path, "w") as f:
        for ts, t, q in zip(timestamps, translations, quaternions_xyzw):
            f.write(
                f"{ts:.6f} "
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def read_tum_trajectory(path: str):
    """Read a TUM pose file -> (timestamps (N,), poses (N, 4, 4) float32)."""
    ts_list, ts_q, ts_t = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) != 8:
                continue
            ts_list.append(vals[0])
            ts_t.append(vals[1:4])
            ts_q.append(vals[4:8])
    if not ts_list:
        return np.array(ts_list), np.zeros((0, 4, 4))
    q = torch.from_numpy(np.array(ts_q, np.float32))
    poses = np.tile(np.eye(4, dtype=np.float32), (len(ts_list), 1, 1))
    poses[:, :3, :3] = lie.matrix_from_quaternion(q).numpy()
    poses[:, :3, 3] = np.array(ts_t, np.float32)
    return np.array(ts_list), poses
