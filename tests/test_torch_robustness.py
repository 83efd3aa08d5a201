"""The JAX package's solver-mode and relocalization gates on already-ported
modules, run on the port and against the JAX package on the same frames
(160x120, CPU, plain kernel versions; JAX jitted on the CPU as its own tests
run it): tests/test_solver_modes.py:25-95 (``gn_fixed`` against ``lm``, depth
holes) and tests/test_relocalization.py:40-123,175 (the disabled ring, the
tight and the default jump gate, ``vo_scan`` coasting; the frame that coasts
in ``VOSystem`` is in test_torch_vo.py).  test_torch_stress.py holds the
twins of tests/test_system.py and tests/test_autotune.py and shares this
file's helpers.

Each case holds the port to the JAX test's own gate (ATE, counters) and to
the JAX package itself: per-frame promoted / relocalized / lost flags
identical, poses within 1e-4 m and 1e-4 rad.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import system as jsystem
from revo_tpu.parallel import batch as jbatch
from revo_tpu_torch import convert, system
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.parallel import batch

from test_solver import small_cfg
from test_torch_vo import assert_poses_close, run_host

torch.set_num_threads(1)


def _tracker(cfg, **kw):
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, **kw))


def _solver(cfg, name):
    return _tracker(cfg, optimizer=dataclasses.replace(cfg.tracker.optimizer, solver=name))


def _sequence(n, seed, scene=None, cam=None):
    """(frames [(gray, depth, ts)], ground truth (n, 4, 4)) of a handheld walk."""
    seq = list(tsyn.render_sequence(scene or tsyn.SyntheticScene(),
                                    cam or small_cfg().camera, n, seed=seed))
    return [(g, d, ts) for g, d, _, ts in seq], np.stack([T for _, _, T, _ in seq])


def _both(cfg, frames, tol=1e-4):
    """``frames`` through both VOSystems: flags equal, poses within ``tol``.
    Returns the port's (poses, flags, system)."""
    pj, fj = run_host(jsystem.VOSystem(cfg), frames)
    vt = system.VOSystem(convert.config_from_jax(cfg), device="cpu")
    pt, ft = run_host(vt, frames)
    np.testing.assert_array_equal(ft, fj)
    assert_poses_close(pt, pj, tol=tol)
    return pt, ft, vt


def _ate(poses, gt):
    return absolute_trajectory_error(poses, gt).rmse


# -- tests/test_solver_modes.py ----------------------------------------------------


@pytest.fixture(scope="module")
def walk25():
    return _sequence(25, seed=4)


def test_gn_fixed_matches_lm_ate(walk25):
    """The fixed-iteration GN fast path may not be worse than the reference
    LM schedule by more than 50% (both sub-cm), inside the port."""
    frames, gt = walk25
    ate = {}
    for name in ("lm", "gn_fixed"):
        poses, flags, _ = _both(_solver(small_cfg(), name), frames)
        ate[name] = _ate(poses, gt)
        assert flags[:, 2].sum() == 0
    assert ate["lm"] < 0.02, f"LM ATE {ate['lm'] * 100:.2f} cm"
    assert ate["gn_fixed"] < 0.02, f"GN ATE {ate['gn_fixed'] * 100:.2f} cm"
    assert ate["gn_fixed"] < max(ate["lm"] * 1.5, 0.005), ate


def test_gn_fixed_with_holes():
    frames, gt = _sequence(15, seed=6, scene=tsyn.SyntheticScene(depth_hole_frac=0.15))
    poses, _, _ = _both(_solver(small_cfg(), "gn_fixed"), frames)
    assert _ate(poses, gt) < 0.03


# -- tests/test_relocalization.py --------------------------------------------------


def test_disabled_reloc_keeps_reference_behavior():
    frames, _ = _sequence(5, seed=13)
    cfg = _tracker(small_cfg(), enable_relocalization=False)
    _, _, vo = _both(cfg, frames)
    assert vo.n_tracking_lost == 0 and len(vo.kf_history) >= 1 and vo.reloc_ring is None
    # Without the ring a frame with no structure is not even marked lost:
    # the reference's behaviour, tracking goes on from whatever LM returned.
    flat = np.full(frames[0][0].shape, 128.0, np.float32)
    vo.process_frame(flat, np.zeros_like(flat), 99.0)
    assert vo.n_tracking_lost == 0 and vo.n_relocalized == 0


def test_tight_gate_coasts_not_crashes(walk25):
    """With an absurdly tight jump gate every frame is flagged; the system
    falls back to relocalization or coasting and survives the sequence."""
    frames, _ = walk25
    cfg = _tracker(small_cfg(), max_jump_translation=1e-6, max_jump_rotation=1e-6)
    poses, flags, vo = _both(cfg, frames[:10])
    assert len(poses) == 10 and np.isfinite(poses).all()
    assert (flags[1:, 1] + flags[1:, 2] == 1).all()  # each frame relocalized or lost


def test_default_gate_never_fires_on_clean_run(walk25):
    frames, _ = walk25
    _, flags, vo = _both(small_cfg(), frames[:15])
    assert vo.report().tracking_lost == 0 and flags[:, 1].sum() == 0


def test_scan_unrecoverable_coasts():
    """A garbage frame fails ring relocalization and coasts on the
    constant-velocity prior inside vo_scan, as in JAX's lax.scan twin."""
    cfg = _tracker(small_cfg(), scan_relocalization=True, max_jump_translation=0.04)
    frames, _ = _sequence(6, seed=12)
    flat = np.full(frames[0][0].shape, 128.0, np.float32)
    grays = np.stack([f[0] for f in frames] + [flat])
    depths = np.stack([f[1] for f in frames] + [np.zeros_like(flat)])
    pj, oj, _ = jbatch.vo_scan(jnp.asarray(grays), jnp.asarray(depths), cfg)
    pt, ot, _ = batch.vo_scan(torch.from_numpy(grays), torch.from_numpy(depths),
                              convert.config_from_jax(cfg))
    for name in ("promoted", "relocalized", "lost"):
        np.testing.assert_array_equal(getattr(ot, name).numpy(), np.asarray(getattr(oj, name)))
    assert bool(ot.lost[6]) and not bool(ot.relocalized[6])
    pt = pt.numpy().astype(np.float64)
    assert_poses_close(pt, np.asarray(pj, np.float64))
    assert np.isfinite(pt).all() and np.linalg.norm(pt[6, :3, 3] - pt[5, :3, 3]) < 0.05
