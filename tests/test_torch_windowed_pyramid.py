"""The port's coarse-to-fine windowed BA and its keyframe entry
(revo_tpu_torch.parallel.windowed: ``optimize_window_pyramid``,
``refine_keyframes``, the divergent-start case) against the JAX package's, on
the CPU at 160x120; the pair pass, one system, the overlap pairs and
``optimize_window`` are held in tests/test_torch_windowed.py.

Tolerances: poses within 1e-4 of jitted JAX's, final errors within 1e-3
relative.  The seeds are those of tests/test_windowed.py, away from
accept/reject ties of the LM schedule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import lie as jlie
from revo_tpu.config import OptimizerConfig as JOpt
from revo_tpu.parallel import windowed as jw
from revo_tpu_torch import convert
from revo_tpu_torch.parallel import windowed as tw

from test_solver import CAM as JCAM
from test_solver import small_cfg
from test_torch_windowed import CAM, OPT, POSE_TOL, _pairs, _port
from test_windowed import _build_window, _build_window_at, _pose_errors

torch.set_num_threads(1)


def test_lm_survives_divergent_start_like_jax():
    """tests/test_windowed.py::test_lm_survives_divergent_start: sparse
    constraints, no robust filtering and a big perturbation make raw GN
    (lambda = 0 steps) blow up; the schedule keeps the error from rising."""
    jopt = dataclasses.replace(JOpt(), huber_edge=0.3, use_edge_filter=False)
    opt = convert.config_from_jax(dataclasses.replace(
        small_cfg(), tracker=dataclasses.replace(small_cfg().tracker, optimizer=jopt)
    )).tracker.optimizer
    win, _ = _build_window(n_frames=4, perturb=0.15, seed=21)
    keep = np.zeros_like(np.asarray(win.valid))
    keep[:, :24] = np.asarray(win.valid)[:, :24]
    win = win._replace(valid=jnp.asarray(keep))
    twin = _port(win)
    pairs_j = jw.make_pairs(4, radius=3)
    pairs = _pairs(pairs_j)

    def err_at(poses):
        return float(tw._accumulate_pairs(twin._replace(poses=poses), *pairs, CAM, opt, 0, 4)[2])

    e0 = err_at(twin.poses)
    poses, diverged = twin.poses, False
    for _ in range(6):
        H, b, _ = tw._accumulate_pairs(twin._replace(poses=poses), *pairs, CAM, opt, 0, 4)
        poses, _ = tw._window_step(poses, H, b, 4, 0.0)
        if err_at(poses) > e0 * 1.05:
            diverged = True
            break
    assert diverged, "perturbation too mild to exercise the damping"
    p_t, e_t = tw.optimize_window(twin, *pairs, CAM, opt, iters=12, damping=1.0)
    assert float(e_t) <= e0 * 1.0001 and bool(torch.isfinite(p_t).all())
    _, e_j = jw.optimize_window(win, *pairs_j, JCAM, jopt, iters=12, damping=1.0)
    assert float(e_t) == pytest.approx(float(e_j), rel=1e-3)


@pytest.mark.parametrize("carry", [True, False])
def test_optimize_window_pyramid_matches_jax(carry):
    win0, true = _build_window(n_frames=4, perturb=0.02, seed=9)
    win1, _ = _build_window_at(JCAM.level(1), true)
    win1 = win1._replace(poses=win0.poses)
    pairs_j = jw.make_pairs(4, radius=2)
    p_j, e_j = jw.optimize_window_pyramid(
        (win0, win1), *pairs_j, (JCAM, JCAM.level(1)), JOpt(), iters_per_lvl=(8, 8),
        carry_damping=carry)
    p_t, e_t = tw.optimize_window_pyramid(
        (_port(win0), _port(win1)), *_pairs(pairs_j), (CAM, CAM.level(1)), OPT,
        iters_per_lvl=(8, 8), carry_damping=carry)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=POSE_TOL)
    assert float(e_t) == pytest.approx(float(e_j), rel=1e-3)
    init, errs = _pose_errors(np.asarray(win0.poses), true), _pose_errors(p_t.numpy(), true)
    assert errs.max() < init.max()
    np.testing.assert_allclose(p_t[0].numpy(), np.asarray(win0.poses[0]), atol=1e-6)


@pytest.fixture(scope="module")
def rendered_keyframes():
    """The keyframes of tests/test_windowed.py's refine_keyframes cases, as
    JAX Keyframes and converted to the port: (a) four handheld keyframes
    whose stored poses are perturbed by exp(N(0, 0.008)); (b) the
    out-and-back six whose drift grows to the revisit."""
    from revo_tpu.frontend import build_frame, make_keyframe
    from revo_tpu.io.synthetic import SyntheticScene, render_frame

    cfg = small_cfg()
    scene = SyntheticScene()

    def build(true_poses, stored):
        kfs = []
        for T, Ts in zip(true_poses, stored):
            g, d = render_frame(scene, cfg.camera, T)
            kfs.append(make_keyframe(build_frame(jnp.asarray(g), jnp.asarray(d), cfg),
                                     jnp.asarray(Ts), cfg))
        port = [convert.keyframe_from_numpy(jax.tree.map(np.asarray, k), device="cpu") for k in kfs]
        return kfs, port, np.stack(true_poses)

    def exp(xi):
        return np.asarray(jlie.matrix_from_rt(*jlie.exp_se3(jnp.asarray(xi))))

    rng = np.random.default_rng(3)
    true_a = [np.eye(4, dtype=np.float32)]
    for _ in range(3):
        true_a.append(true_a[-1] @ exp(rng.normal(size=6).astype(np.float32) * 0.02))
    stored_a = [exp(rng.normal(size=6).astype(np.float32) * 0.008) @ T for T in true_a]
    stored_a[0] = true_a[0]  # gauge
    rng = np.random.default_rng(11)
    xi = np.array([0.05, 0.012, 0.02, 0.004, 0.025, 0.0], np.float32)
    true_b = [exp(a * xi) for a in [0.0, 1.0, 2.0, 2.2, 1.1, 0.05]]
    stored_b = [exp(rng.normal(size=6).astype(np.float32) * 0.01 * k / 5.0) @ T
                for k, T in enumerate(true_b)]
    stored_b[0] = true_b[0]
    return cfg, convert.config_from_jax(cfg), build(true_a, stored_a), build(true_b, stored_b)


def _max_t_err(poses, true):
    return max(np.linalg.norm(p[:3, 3] - T[:3, 3]) for p, T in zip(poses, true))


def test_refine_keyframes_matches_jax(rendered_keyframes):
    cfg, tcfg, (kfs_j, kfs_t, true), _ = rendered_keyframes
    init = _max_t_err([k.T_w_k.numpy() for k in kfs_t], true)
    got = tw.refine_keyframes(kfs_t, tcfg)
    assert isinstance(got, np.ndarray) and got.shape == (4, 4, 4)
    assert _max_t_err(got, true) < init * 0.7
    np.testing.assert_allclose(got, jw.refine_keyframes(kfs_j, cfg), rtol=0, atol=POSE_TOL)
    # Pruned keyframes (what VOSystem retains) refine to the same poses.
    from revo_tpu_torch.frontend import prune_keyframe

    np.testing.assert_array_equal(
        tw.refine_keyframes([prune_keyframe(k) for k in kfs_t], tcfg), got)


@pytest.mark.parametrize("case", ["ring", "extra_pairs", "extra_pairs_poses0"])
def test_refine_keyframes_loop_edge_matches_jax(rendered_keyframes, case):
    cfg, tcfg, _, (kfs_j, kfs_t, true) = rendered_keyframes
    kw = dict(pairs="ring", radius=1)
    if case != "ring":
        kw["extra_pairs"] = [(0, 5, 2.0)]
    if case == "extra_pairs_poses0":
        # Start from poses pulled half way back to truth, as a loop
        # closure's correction would hand them over.
        stored = np.stack([k.T_w_k.numpy() for k in kfs_t])
        mid = stored.copy()
        mid[:, :3, 3] = 0.5 * (stored[:, :3, 3] + true[:, :3, 3])
        kw["poses0"] = mid
    got = tw.refine_keyframes(kfs_t, tcfg, **kw)
    want = jw.refine_keyframes(kfs_j, cfg, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)
    if case == "extra_pairs":
        plain = tw.refine_keyframes(kfs_t, tcfg, pairs="ring", radius=1)
        err = [np.linalg.norm(p[5][:3, 3] - true[5][:3, 3]) for p in (got, plain)]
        assert err[0] < err[1]
