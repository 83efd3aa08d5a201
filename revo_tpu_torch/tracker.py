"""Coarse-to-fine SE(3) frame-to-keyframe tracking (counterpart of
revo_tpu/tracker.py::track_frames).

TrackerNew::trackFrames (tracker.cpp:294-353): check the initial pose
against identity, then solve each pyramid level from PYR_MIN_LVL (coarse)
down to PYR_MAX_LVL (fine), each level starting from the previous one's
pose.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from revo_tpu_torch import solver
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import Frame, Keyframe


class TrackResult(NamedTuple):
    R: torch.Tensor  # (3, 3) keyframe <- current rotation
    t: torch.Tensor  # (3,)
    error: torch.Tensor  # () final mean weighted error
    good: torch.Tensor  # () int32
    bad: torch.Tensor  # () int32
    new_kf: torch.Tensor  # () bool: good/bad < good_bad_ratio_new_kf


def track_frames(
    kf: Keyframe, frame: Frame, R0: torch.Tensor, t0: torch.Tensor, cfg: SystemConfig
) -> TrackResult:
    """Track ``frame`` against ``kf`` from the initial pose (R0, t0)."""
    pyr = cfg.pyramid
    opt = cfg.tracker.optimizer
    cams = cfg.camera_pyramid()
    R, t = R0, t0
    if cfg.tracker.check_init_values:
        # "DO NOT INIT WITH PREVIOUS TRANSFORM" (tracker.cpp:277-282), only
        # when identity is clearly better (TrackerConfig.init_check_margin).
        lvl = pyr.pyr_min_lvl
        cloud = frame.levels[lvl].cloud
        dt_img = kf.structs[lvl][..., 2]
        eye, zero = torch.eye(3, device=R.device), torch.zeros(3, device=R.device)

        def cost(R_, t_):
            return solver.eval_cost(
                dt_img, cloud, cams[lvl], R_, t_, opt.edge_distance_lvl[lvl],
                opt.use_edge_filter, cfg.tracker.normalized_init_cost,
            )

        use_eye = cost(eye, zero) < cfg.tracker.init_check_margin * cost(R, t)
        R = torch.where(use_eye, eye, R)
        t = torch.where(use_eye, zero, t)

    info = None
    err = None
    for lvl in range(pyr.pyr_min_lvl, pyr.pyr_max_lvl - 1, -1):
        R, t, err, info = solver.solve_level(
            kf.quads[lvl], frame.levels[lvl].cloud, cams[lvl], R, t, opt, lvl
        )
    good_f = info.good.to(torch.float32)
    bad_f = torch.clamp(info.bad, min=1).to(torch.float32)
    new_kf = (good_f / bad_f) < cfg.tracker.good_bad_ratio_new_kf
    return TrackResult(R=R, t=t, error=err, good=info.good, bad=info.bad, new_kf=new_kf)
