"""Recorded-capture modality: write a frame stream to a TUM-format dataset
(copy of revo_tpu/io/recorder.py).

Replaces IOWrapperRGBD::writeImages (iowrapperRGBD.cpp:181-217): live or
synthetic frames are written as rgb/ + depth/ PNG pairs with an
associate.txt, producing a dataset that the dataset modality (and the
reference itself) can replay.
"""
from __future__ import annotations

import os
import numpy as np


class TUMRecorder:
    """Append frames to a TUM-format dataset directory."""

    def __init__(self, out_dir: str, depth_scale: float = 5000.0):
        self.out_dir = out_dir
        self.depth_scale = depth_scale
        os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
        self._assoc = open(os.path.join(out_dir, "associate.txt"), "w")
        self.n = 0

    def add(
        self,
        gray_or_rgb: np.ndarray,
        depth_m: np.ndarray,
        timestamp: float,
    ) -> None:
        """Write one frame: 8-bit rgb PNG + 16-bit depth PNG + assoc line."""
        import cv2  # host-side encode only

        img = np.asarray(gray_or_rgb)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = np.clip(img, 0, 255).astype(np.uint8)
        depth_u16 = np.clip(
            np.asarray(depth_m) * self.depth_scale, 0, 65535
        ).astype(np.uint16)

        rgb_rel = f"rgb/{timestamp:.6f}.png"
        dep_rel = f"depth/{timestamp:.6f}.png"
        cv2.imwrite(os.path.join(self.out_dir, rgb_rel), img)
        cv2.imwrite(os.path.join(self.out_dir, dep_rel), depth_u16)
        self._assoc.write(
            f"{timestamp:.6f} {rgb_rel} {timestamp:.6f} {dep_rel}\n"
        )
        self._assoc.flush()
        self.n += 1

    def close(self) -> None:
        if not self._assoc.closed:
            self._assoc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
