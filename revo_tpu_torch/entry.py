"""The forward step that a compile check builds and runs (counterpart of
``__graft_entry__.entry`` at the repo root).

``entry()`` returns the full 640x480 frame-to-keyframe tracking step of the
flagship configuration and example arguments for it: a keyframe built from
one synthetic frame and a second frame rendered after a small motion.
"""
from __future__ import annotations

import numpy as np
import torch

from revo_tpu_torch import lie, tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import build_frame, make_keyframe
from revo_tpu_torch.io.synthetic import SyntheticScene, render_frame
from revo_tpu_torch.kernels import check_device


def _flagship_cfg():
    return SystemConfig()  # 640x480 TUM fr1 intrinsics, 3 levels


def entry(device="cuda"):
    """(fn, example_args): ``fn(kf, frame, R0, t0)`` tracks ``frame`` against
    ``kf`` from (R0, t0) and returns a ``tracker.TrackResult``; the
    arguments live on ``device`` (a CUDA device raises without a card)."""
    device = check_device(device)
    cfg = _flagship_cfg()
    scene = SyntheticScene()
    T0 = np.eye(4, dtype=np.float32)
    dR, dt = lie.exp_se3(torch.tensor([0.01, -0.005, 0.008, 0.004, 0.002, -0.003]))
    T1 = T0 @ lie.matrix_from_rt(dR, dt).numpy()
    g0, d0 = render_frame(scene, cfg.camera, T0)
    g1, d1 = render_frame(scene, cfg.camera, T1)
    f0 = build_frame(torch.from_numpy(g0).to(device), torch.from_numpy(d0).to(device), cfg)
    f1 = build_frame(torch.from_numpy(g1).to(device), torch.from_numpy(d1).to(device), cfg)
    kf = make_keyframe(f0, torch.eye(4, device=device), cfg)

    def fn(kf_, frame_, R0, t0):
        return tracker.track_frames(kf_, frame_, R0, t0, cfg)

    example_args = (kf, f1, torch.eye(3, device=device), torch.zeros(3, device=device))
    return fn, example_args
