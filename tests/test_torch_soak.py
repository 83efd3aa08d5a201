"""The JAX package's long runs (tests/test_soak.py) on the port at 160x120 on
the CPU (plain kernel versions; JAX jitted on the CPU as its own tests run
it), on the same frames through both packages.

1. TestSoakLight's combined scenario: 110 frames of one loop in box_scene,
   frames 0..75 then the teleport back to 30 and 32 frames to 61, depth x
   1.08 on frames 30..54 before the teleport, a ring of 8 keyframes, online
   loop closure every 40 frames, jump gate 0.12 m / 0.4 rad (_soak_cfg).
   The port's VOSystem passes every gate of _check_soak at ate_bound 0.09.
   Against the JAX package's VOSystem: per-frame promotion / relocalization
   / lost flags, the counts and the relocalized frame identical; world poses
   within 1e-4 m / 1e-4 rad over frames 0-29 (measured 3.8e-5 m, 1.3e-5
   rad) and within 1e-3 m / 1e-3 rad over the whole run (measured 8.3e-5 m
   at frame 50, 2.2e-5 rad).
2. TestSoakScan1000's scan soak, cut to 160 frames: loop_trajectory(160,
   radius=0.7, wobble=0.004, seed=5, circuits=3), scan relocalization on,
   online closure off, vo_scan_from_state in chunks of 20, the state saved
   to a file after frame 80.  160 is the shortest length (in steps of 10)
   at which the three circuits promote more than kf_history_size times and
   stay on track: at 120 frames (11 cm a frame) the jump gate fires on most
   frames and nothing promotes, at 150 the run promotes 11 times but
   relocalizes 19 times and drifts 0.49 m; at 160 it promotes 17 times.
   Gates: promotions > 8, ATE < 0.08 m, the run resumed from the file
   bit-equal to the run in memory; against JAX's vo_scan_from_state on the
   same chunks: flags identical over all 160 frames, both ATEs < 0.08 m,
   poses within 1e-3 m / 1e-3 rad over the first half (measured 9.9e-5 m,
   3.3e-5 rad), and over the second half each frame stepped by the port from
   JAX's own carried state (JAX's save_scan_state, the port's
   load_scan_state) within 1e-5 m / 1e-5 rad of JAX's step from it
   (measured 7.7e-6 m, 2.7e-6 rad at frame 89; at most 1.6e-6 m on the
   other 78 frames).  The chained poses part further in the second half
   (2.04e-3 m at frame 150, 8.5e-4 on the frame before and 7.4e-4 on the
   frame after) although every step from a common state agrees to float32
   rounding: the normal-equation sums differ in float32 order (the
   per-point terms are bit-equal, tests/test_torch_slice.py) and LM's stop
   and accept decisions carry that difference from frame to frame through
   the motion prior and every promoted keyframe's pose (ROADMAP: gate long
   runs on ATE and short chains on a pose tolerance).

The measured values come from ``scripts/soak_parity.py``, which runs these
functions and prints them.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import system as jsystem
from revo_tpu.checkpoint import save_scan_state as jax_save_scan_state
from revo_tpu.parallel import batch as jbatch
from revo_tpu_torch import convert, frontend, system
from revo_tpu_torch.checkpoint import load_scan_state, save_scan_state
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.frontend import prune_keyframe
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.parallel import batch
from revo_tpu_torch.parallel.windowed import refine_keyframes

from test_soak import _soak_cfg
from test_solver import small_cfg
from test_torch_vo import rot_angle

torch.set_num_threads(1)

# 1. the combined scenario (tests/test_soak.py:161-177)
N_COMBINED, TELEPORT_FROM, TELEPORT_TO, REPLAY, DRIFT = 110, 76, 30, 32, (30, 55)
ATE_BOUND = 0.09
EARLY_FRAMES, EARLY_TOL, RUN_TOL = 30, 1e-4, 1e-3  # metres and radians against JAX
# 2. the scan soak
N_SCAN, CHUNK, SCAN_ATE = 160, 20, 0.08
CKPT_AT = (N_SCAN // CHUNK // 2) * CHUNK  # the state after frame 80
SCAN_TOL, STEP_TOL = 1e-3, 1e-5  # chained poses (first half); one step from a common state


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a tree of NamedTuples and tuples (the port's
    form of tests/test_soak.py's ``tree_nbytes``)."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, tuple):
        return sum(tree_nbytes(x) for x in tree)
    return 0


def max_pose_gap(a, b):
    """(largest translation gap m, largest rotation gap rad) of two pose stacks."""
    dt = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    return dt, max(rot_angle(x[:3, :3], y[:3, :3]) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def cfgs():
    cfg = _soak_cfg(small_cfg())
    return cfg, convert.config_from_jax(cfg)


# -- 1. the combined scenario --------------------------------------------------


def _counters(vo):
    return np.array([vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost])


def _run_combined(vo, rendered):
    """tests/test_soak.py _run_soak's frame loop; returns (poses, per-frame
    (promoted, relocalized, lost) increments)."""
    order = list(range(TELEPORT_FROM)) + list(range(TELEPORT_TO, TELEPORT_TO + REPLAY))
    est, flags = [], []
    for k, i in enumerate(order):
        gray, depth, _, _ = rendered[i]
        scale = 1.08 if (k < TELEPORT_FROM and DRIFT[0] <= i < DRIFT[1]) else 1.0
        before = _counters(vo)
        est.append(np.asarray(vo.process_frame(gray, depth * scale, float(k) / 30.0), np.float64))
        flags.append(_counters(vo) - before)
    return np.stack(est), np.stack(flags)


def run_combined(cfg, tcfg):
    """The combined scenario through the port's and the JAX package's
    VOSystem on the same rendered frames (``cfg`` the JAX config, ``tcfg``
    the port's)."""
    traj = tsyn.loop_trajectory(N_COMBINED, radius=0.75, wobble=0.004, seed=5)
    rendered = list(tsyn.render_trajectory(tsyn.box_scene(), cfg.camera, traj, seed=5))
    order = list(range(TELEPORT_FROM)) + list(range(TELEPORT_TO, TELEPORT_TO + REPLAY))
    vo = system.VOSystem(tcfg, device="cpu")
    est, flags = _run_combined(vo, rendered)
    vo_j = jsystem.VOSystem(cfg)
    est_j, flags_j = _run_combined(vo_j, rendered)
    return {"vo": vo, "est": est, "flags": flags, "gt": traj[order],
            "vo_jax": vo_j, "est_jax": est_j, "flags_jax": flags_j}


@pytest.fixture(scope="module")
def combined(cfgs):
    return run_combined(*cfgs)


def test_combined_scenario_tracks_and_relocalizes(combined):
    """_check_soak's accuracy gates: final-graph ATE, the relocalization,
    the tail."""
    vo, est, gt = combined["vo"], combined["est"], combined["gt"]
    ate_final = absolute_trajectory_error(np.stack([n.T_w_curr for n in vo.pose_graph]), gt)
    assert ate_final.rmse < ATE_BOUND, f"final-graph ATE {ate_final.rmse:.4f} m"
    assert vo.n_relocalized >= 1, "teleport did not exercise relocalization"
    tail = np.linalg.norm(est[-10:, :3, 3] - gt[-10:, :3, 3], axis=-1).mean()
    assert tail < ATE_BOUND * 1.5, f"tail error {tail:.4f} m still growing"


def test_combined_scenario_ring_evicts_and_stores_pruned_slots(combined, cfgs):
    """_check_soak's ring gates: eviction happened and stayed bounded, and
    no stored slot keeps the images tracking never reads."""
    vo, size = combined["vo"], cfgs[1].tracker.kf_history_size
    assert len(vo.kf_history) <= size < vo.n_keyframes
    full = tree_nbytes(vo.kf)  # the live keyframe stays unpruned
    pruned = tree_nbytes(prune_keyframe(vo.kf))
    slots = [tree_nbytes(kf) for _, kf in vo.kf_history]
    assert max(slots) <= pruned + 4096, f"history slot {max(slots)} B, pruned {pruned} B"
    assert pruned < 0.8 * full, f"pruning saved too little: {pruned}/{full} B"
    assert sum(slots) <= size * (pruned + 4096)


def test_combined_scenario_windowed_ba_over_the_ring(combined, cfgs):
    """Post-run windowed BA over the retained (pruned) ring stays finite."""
    refined = refine_keyframes([kf for _, kf in combined["vo"].kf_history], cfgs[1],
                               pairs="overlap")
    assert refined.shape == (len(combined["vo"].kf_history), 4, 4)
    assert np.isfinite(refined).all()


def test_combined_scenario_flags_match_jax(combined):
    vo, vo_j = combined["vo"], combined["vo_jax"]
    np.testing.assert_array_equal(combined["flags"], combined["flags_jax"])
    assert (vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost) == (
        vo_j.n_keyframes, vo_j.n_relocalized, vo_j.n_tracking_lost)
    reloc = np.nonzero(combined["flags"][:, 1])[0]
    assert reloc.tolist() == np.nonzero(combined["flags_jax"][:, 1])[0].tolist()
    assert reloc.tolist() == [TELEPORT_FROM]  # the teleport frame itself


@pytest.mark.parametrize("frames,tol", [(EARLY_FRAMES, EARLY_TOL), (None, RUN_TOL)],
                         ids=["frames_0_29", "whole_run"])
def test_combined_scenario_poses_match_jax(combined, frames, tol):
    est, est_j = combined["est"][:frames], combined["est_jax"][:frames]
    dt, dr = max_pose_gap(est, est_j)
    assert dt <= tol and dr <= tol, f"poses differ from JAX by {dt} m, {dr} rad"


# -- 2. the scan soak --------------------------------------------------------------


def scan_cfgs(cfg):
    """(JAX, port) configs of the scan soak from the JAX soak config."""
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, scan_relocalization=True, online_loop_closure=False))
    return cfg, convert.config_from_jax(cfg)


def _flags(outs):
    return np.stack([np.asarray(outs.promoted), np.asarray(outs.relocalized),
                     np.asarray(outs.lost)], axis=1)


def render_scan(cfg, n_frames=N_SCAN):
    """The scan soak's frames as a sensor gives them: (uint8 gray, uint16
    depth, ground truth)."""
    traj = tsyn.loop_trajectory(n_frames, radius=0.7, wobble=0.004, seed=5, circuits=3)
    frames = list(tsyn.render_trajectory(tsyn.box_scene(), cfg.camera, traj, seed=5))
    g_all = np.stack([f[0] for f in frames]).astype(np.uint8)
    d_all = np.stack([(f[1] * cfg.dataset.depth_scale_factor).astype(np.uint16) for f in frames])
    return g_all, d_all, traj


def run_scan_port(tcfg, g_all, d_all, ckpt=None):
    """The port's scan in chunks of CHUNK, the state written to ``ckpt``
    after frame CKPT_AT: (poses, (promoted, relocalized, lost) per frame)."""
    state = batch._init_state(frontend.build_frame(
        torch.from_numpy(g_all[0]), torch.from_numpy(d_all[0]), tcfg), tcfg)
    poses, flags = [np.eye(4, dtype=np.float32)[None]], [np.zeros((1, 3), bool)]
    for a in range(1, len(g_all), CHUNK):
        b = min(a + CHUNK, len(g_all))
        T_w, outs, state = batch.vo_scan_from_state(
            state, torch.from_numpy(g_all[a:b]), torch.from_numpy(d_all[a:b]), tcfg)
        poses.append(T_w.numpy())
        flags.append(_flags(outs))
        if b == CKPT_AT + 1 and ckpt is not None:
            save_scan_state(ckpt, state)
    return np.concatenate(poses), np.concatenate(flags)


def run_scan(cfg, tcfg, tmp):
    """The scan soak in both packages (module docstring), checkpoint files
    in the directory ``tmp``."""
    g_all, d_all, traj = render_scan(cfg)
    ckpt = str(tmp / "scan_soak.npz")
    poses, flags = run_scan_port(tcfg, g_all, d_all, ckpt)
    resumed = []
    state_r = load_scan_state(ckpt, tcfg, device="cpu")
    for a in range(CKPT_AT + 1, N_SCAN, CHUNK):
        b = min(a + CHUNK, N_SCAN)
        T_w, _, state_r = batch.vo_scan_from_state(
            state_r, torch.from_numpy(g_all[a:b]), torch.from_numpy(d_all[a:b]), tcfg)
        resumed.append(T_w.numpy())

    # The JAX package on the same chunks; its carried state after frame
    # CKPT_AT, then stepped one frame at a time over the second half, the
    # port stepping each frame from the same state.
    state_j = jbatch._init_state(jfront.build_frame(
        jnp.asarray(g_all[0]), jnp.asarray(d_all[0]), cfg), cfg)
    poses_j, flags_j = [np.eye(4, dtype=np.float32)[None]], [np.zeros((1, 3), bool)]
    for a in range(1, N_SCAN, CHUNK):
        b = min(a + CHUNK, N_SCAN)
        T_w, outs, state_j = jbatch.vo_scan_from_state(
            state_j, jnp.asarray(g_all[a:b]), jnp.asarray(d_all[a:b]), cfg)
        poses_j.append(np.asarray(T_w))
        flags_j.append(_flags(outs))
        if b == CKPT_AT + 1:
            stepped_j = state_j
    steps = []  # (port pose, JAX pose, port flags, JAX flags) of each frame
    step_file = str(tmp / "jax_state.npz")
    for k in range(CKPT_AT + 1, N_SCAN):
        jax_save_scan_state(step_file, stepped_j)
        T_t, outs_t, _ = batch.vo_scan_from_state(
            load_scan_state(step_file, tcfg, device="cpu"), torch.from_numpy(g_all[k:k + 1]),
            torch.from_numpy(d_all[k:k + 1]), tcfg)
        T_j, outs_j, stepped_j = jbatch.vo_scan_from_state(
            stepped_j, jnp.asarray(g_all[k:k + 1]), jnp.asarray(d_all[k:k + 1]), cfg)
        steps.append((T_t.numpy()[0], np.asarray(T_j)[0], _flags(outs_t)[0], _flags(outs_j)[0]))
    return {"gt": traj, "poses": poses, "flags": flags,
            "resumed": np.concatenate(resumed), "poses_jax": np.concatenate(poses_j),
            "flags_jax": np.concatenate(flags_j), "steps": steps}


@pytest.fixture(scope="module")
def scan(cfgs, tmp_path_factory):
    return run_scan(*scan_cfgs(cfgs[0]), tmp_path_factory.mktemp("scan_soak"))


def test_scan_soak_promotes_and_tracks(scan, cfgs):
    poses, flags = scan["poses"], scan["flags"]
    assert poses.shape == (N_SCAN, 4, 4) and np.isfinite(poses).all()
    assert flags[:, 0].sum() > cfgs[1].tracker.kf_history_size, "no eviction in the run"
    ate = absolute_trajectory_error(poses, scan["gt"]).rmse
    assert ate < SCAN_ATE, f"scan soak ATE {ate:.4f} m"


def test_scan_soak_resumes_from_its_checkpoint_bit_equal(scan):
    """The state after frame 80 (a full ring: 8 slots, their quad tables
    rebuilt from the stored structures on load) written to a file, loaded
    and continued: every pose equals the continuation in memory."""
    assert np.array_equal(scan["resumed"], scan["poses"][CKPT_AT + 1:])


def test_scan_soak_flags_and_ate_match_jax(scan):
    np.testing.assert_array_equal(scan["flags"], scan["flags_jax"])
    ate_j = absolute_trajectory_error(scan["poses_jax"].astype(np.float64), scan["gt"]).rmse
    assert ate_j < SCAN_ATE, f"JAX scan soak ATE {ate_j:.4f} m"


def test_scan_soak_poses_match_jax_first_half(scan):
    n = CKPT_AT + 1
    dt, dr = max_pose_gap(scan["poses"][:n].astype(np.float64),
                          scan["poses_jax"][:n].astype(np.float64))
    assert dt <= SCAN_TOL and dr <= SCAN_TOL, f"poses differ from JAX by {dt} m, {dr} rad"


def test_scan_soak_steps_from_jax_state_match_jax(scan):
    """Every frame of the second half stepped by both packages from JAX's
    carried state, moved into the port through a checkpoint file."""
    for k, (T_t, T_j, f_t, f_j) in enumerate(scan["steps"], start=CKPT_AT + 1):
        np.testing.assert_array_equal(f_t, f_j, err_msg=f"frame {k}")
        dt, dr = max_pose_gap(T_t[None].astype(np.float64), T_j[None].astype(np.float64))
        assert dt <= STEP_TOL and dr <= STEP_TOL, f"frame {k}: {dt} m, {dr} rad"
