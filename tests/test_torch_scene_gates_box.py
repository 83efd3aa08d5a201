"""tests/test_scenes.py's accuracy gates held in the port, box and column
families (CPU, plain kernel versions): each case renders the frames the JAX
test renders, at 160x120 (``small_cfg``), and runs them through the port's
``VOSystem(device="cpu")`` and the JAX package's ``VOSystem`` (jitted on the
CPU, as its own tests run it).

Checks, per case:
- the JAX test's own gate on the port's run: its ATE limit and, where the
  JAX test asks it, ``n_tracking_lost == 0``;
- per-frame promoted / relocalized / lost flags identical to JAX's;
- poses: the median per-frame gap to JAX's within 5e-5 m and 5e-5 rad
  (tests/test_torch_scenes.py's tolerance), and every frame within the
  case's own tolerance.

Why each case has its own pose tolerance: none of these runs promotes a
keyframe after frame 0, so every frame is tracked against keyframe 0 across
a growing baseline from a motion prior built on the frames before it.  The
two packages' normal-equation sums differ in float32 order, LM stops at a
slightly different point, and the gap grows by about 2 um a frame (12
frames stay under 5e-5, as tests/test_torch_scenes.py holds); on some
frames LM's accept / reject or stopping test parts (ROADMAP "Knife-edge
basins") and that frame alone jumps.  Each tolerance is about twice the
largest gap measured on the CPU, whose frame and size its comment gives
(frame index, metres, radians); flags and ATE gates are not widened.

The photometric and sparse families are in
tests/test_torch_scene_gates_sensor.py, which imports ``hold_gate``.
"""
import numpy as np
import torch

from revo_tpu import system as jsystem
from revo_tpu.io import synthetic as jsyn
from revo_tpu_torch import convert, system
from revo_tpu_torch.eval.ate import absolute_trajectory_error

from test_solver import small_cfg
from test_torch_vo import rot_angle, run_host

torch.set_num_threads(1)

SCENE_TOL = 5e-5  # metres and radians, port against JAX: the median frame


def sequence(scene, n, seed):
    """tests/test_scenes.py's ``render_sequence(scene, cfg.camera, n, seed)``."""
    return lambda cam: jsyn.render_sequence(scene, cam, n, seed=seed)


def fast_motion(scene):
    """tests/test_scenes.py's 5x handheld envelope: 40 frames, 4 cm and
    0.015 rad a step, seed 6."""
    traj = scene.trajectory(40, seed=6, translation_step=0.04, rotation_step=0.015)
    return lambda cam: jsyn.render_trajectory(scene, cam, traj, seed=6)


def pose_gaps(a, b):
    """Per-frame translation (m) and rotation (rad) gaps between two runs."""
    dt = np.abs(a[:, :3, 3] - b[:, :3, 3]).max(axis=-1)
    dr = np.array([rot_angle(x[:3, :3], y[:3, :3]) for x, y in zip(a, b)])
    return dt, dr


def hold_gate(render, ate_limit, pose_tol, require_tracking=True):
    """Run the rendered frames through both VOSystems and hold the port to
    the JAX test's gate and to JAX's per-frame flags and poses (median gap
    within SCENE_TOL, every frame within ``pose_tol``).  Returns (port ATE,
    JAX ATE) in metres."""
    cfg = small_cfg()
    rendered = list(render(cfg.camera))
    frames = [(g, d, ts) for g, d, _, ts in rendered]
    gt = np.stack([T for _, _, T, _ in rendered])
    pj, fj = run_host(jsystem.VOSystem(cfg), frames)
    vt = system.VOSystem(convert.config_from_jax(cfg), device="cpu")
    pt, ft = run_host(vt, frames)
    ate_t = absolute_trajectory_error(pt, gt).rmse
    ate_j = absolute_trajectory_error(pj, gt).rmse
    assert ate_t < ate_limit, f"port ATE {ate_t:.4f} m (JAX {ate_j:.4f} m), limit {ate_limit}"
    if require_tracking:
        assert vt.n_tracking_lost == 0
    np.testing.assert_array_equal(ft, fj)
    dt, dr = pose_gaps(pt, pj)
    assert np.median(dt) <= SCENE_TOL and np.median(dr) <= SCENE_TOL, (
        f"median gap {np.median(dt)} m, {np.median(dr)} rad")
    assert dt.max() <= pose_tol and dr.max() <= pose_tol, (
        f"frame {int(dt.argmax())}: {dt.max()} m; frame {int(dr.argmax())}: {dr.max()} rad")
    return ate_t, ate_j


class TestBoxScene:
    """tests/test_scenes.py:38-85."""

    def test_tracks_through_occlusion(self):
        hold_gate(sequence(jsyn.box_scene(), 30, seed=3), 0.015,
                  pose_tol=1.5e-4)  # frame 28: 6.7e-5 m; frame 19: 1.4e-5 rad

    def test_fast_motion_5x_tracks(self):
        hold_gate(fast_motion(jsyn.box_scene()), 0.02,
                  pose_tol=7e-4)  # frame 37: 3.45e-4 m; frame 34: 9.8e-5 rad

    def test_depth_noise_and_holes(self):
        hold_gate(sequence(jsyn.box_scene(depth_noise=0.04, depth_hole_frac=0.2), 30, seed=3),
                  0.03, pose_tol=2e-4)  # frame 27: 1.00e-4 m; frame 26: 3.1e-5 rad


class TestColumnScene:
    """tests/test_scenes.py:88-122."""

    def test_tracks_on_curved_surfaces(self):
        hold_gate(sequence(jsyn.column_scene(), 30, seed=4), 0.015,
                  pose_tol=3e-4)  # frame 12: 1.64e-4 m; frame 24: 4.6e-5 rad

    def test_fast_motion_5x_tracks(self):
        # Frame 33 alone jumps (the frames around it stay under 7e-5 m).
        hold_gate(fast_motion(jsyn.column_scene()), 0.02,
                  pose_tol=3e-3)  # frame 33: 1.423e-3 m, 4.30e-4 rad
