"""The port's device-loop VO (parallel/batch.py: vo_scan, vo_scan_from_state,
vo_scan_batched) against JAX's ``lax.scan`` twin and against the port's own
host loop, at 160x120 on the CPU (plain kernel versions; JAX jitted).

Tolerances: per-frame promoted / relocalized / lost flags identical and
poses within 1e-4 m and 1e-4 rad of JAX's vo_scan; against the port's
VOSystem, flags identical and poses within 5e-4 (the JAX package's own
host-vs-scan gate, tests/test_batch.py:35-48); batched lanes exactly equal
to vo_scan of the same sequence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.parallel import batch as jbatch
from revo_tpu_torch import convert, system
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.parallel import batch

from test_solver import small_cfg
from test_torch_vo import assert_poses_close, pan_sequence, run_host

torch.set_num_threads(1)

N_PAN = 20


def _cfgs(scan_relocalization):
    """small_cfg; with scan relocalization also the tightened jump gate of
    tests/test_relocalization.py::TestScanRelocalization."""
    cfg = small_cfg()
    trk = dataclasses.replace(cfg.tracker, scan_relocalization=scan_relocalization)
    if scan_relocalization:
        trk = dataclasses.replace(trk, max_jump_translation=0.04)
    cfg = dataclasses.replace(cfg, tracker=trk)
    return cfg, convert.config_from_jax(cfg)


@pytest.fixture(scope="module")
def pan():
    cam = small_cfg().camera
    frames, gt = pan_sequence(cam, N_PAN)
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]), gt


def _teleport_sequence(cam):
    """tests/test_relocalization.py:130-141: 12 frames (seed 11), then two
    frames back at frame 0's view."""
    scene = tsyn.SyntheticScene()
    seq = list(tsyn.render_sequence(scene, cam, 12, seed=11))
    g0, d0 = tsyn.render_frame(scene, cam, seq[0][2])
    return (np.stack([f[0] for f in seq] + [g0, g0]),
            np.stack([f[1] for f in seq] + [d0, d0]))


def _flags(outs):
    return np.stack([np.asarray(outs.promoted), np.asarray(outs.relocalized),
                     np.asarray(outs.lost)], axis=1)


def _port_scan(grays, depths, tcfg):
    return batch.vo_scan(torch.from_numpy(grays), torch.from_numpy(depths), tcfg)


@pytest.fixture(scope="module")
def pan_scan(pan):
    """The port's vo_scan over the pan."""
    grays, depths, _ = pan
    return _port_scan(grays, depths, _cfgs(False)[1])


@pytest.mark.parametrize("reloc", [False, True])
def test_vo_scan_matches_jax(pan, pan_scan, reloc):
    """Without scan relocalization on the pan, which promotes; with it on a
    teleport sequence, which the ring relocalizes."""
    cfg, tcfg = _cfgs(reloc)
    if reloc:
        grays, depths = _teleport_sequence(cfg.camera)
        pt, ot, st = _port_scan(grays, depths, tcfg)
    else:
        grays, depths, _ = pan
        pt, ot, st = pan_scan
    pj, oj, sj = jbatch.vo_scan(jnp.asarray(grays), jnp.asarray(depths), cfg)
    np.testing.assert_array_equal(_flags(ot), _flags(oj))
    if reloc:
        assert bool(ot.relocalized[12])
    else:
        assert _flags(ot)[:, 0].sum() >= 2
    assert not _flags(ot)[:, 2].any()
    assert_poses_close(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ot.good.numpy(), np.asarray(oj.good))
    assert st.n_keyframes == int(sj.n_keyframes)
    # The converter carries JAX's final state across intact.
    sc = convert.scan_state_from_numpy(jax.tree.map(np.asarray, sj))
    assert (sc.n_keyframes, sc.just_added_kf, sc.past.n) == (
        st.n_keyframes, st.just_added_kf, st.past.n)
    assert (sc.kf_ring is None) == (not reloc)
    assert_poses_close(sc.prev_T_w[None].numpy().astype(np.float64),
                       st.prev_T_w[None].numpy().astype(np.float64))


def test_vo_scan_matches_vosystem(pan, pan_scan):
    grays, depths, _ = pan
    tcfg = _cfgs(False)[1]
    frames = [(grays[i], depths[i], i / 30.0) for i in range(N_PAN)]
    ph, fh = run_host(system.VOSystem(tcfg, device="cpu"), frames)
    ps, os_, _ = pan_scan
    np.testing.assert_array_equal(_flags(os_)[:, 0].astype(int), fh[:, 0] * (np.arange(N_PAN) > 0))
    assert_poses_close(ps.numpy(), ph, tol=5e-4)


def test_vo_scan_from_state_continues(pan, pan_scan):
    """Resuming from a state reproduces the uninterrupted run: frames 0-9
    by vo_scan, then 10-19 from its final state."""
    grays, depths, _ = pan
    tcfg = _cfgs(False)[1]
    g, d = torch.from_numpy(grays), torch.from_numpy(depths)
    _, _, state = batch.vo_scan(g[:10], d[:10], tcfg)
    p2, o2, s2 = batch.vo_scan_from_state(state, g[10:], d[10:], tcfg)
    p_all, o_all, s_all = pan_scan
    assert torch.equal(p2, p_all[10:])
    assert torch.equal(o2.promoted, o_all.promoted[10:])
    assert s2.n_keyframes == s_all.n_keyframes


def test_vo_scan_batched_lanes_equal_vo_scan(pan):
    grays, depths, _ = pan
    tcfg = _cfgs(False)[1]
    other = list(tsyn.render_sequence(tsyn.SyntheticScene(), tcfg.camera, 8, seed=5))
    g = torch.from_numpy(np.stack([grays[:8], np.stack([f[0] for f in other])]))
    d = torch.from_numpy(np.stack([depths[:8], np.stack([f[1] for f in other])]))
    poses = batch.vo_scan_batched(g, d, tcfg)
    assert poses.shape == (2, 8, 4, 4)
    for b in range(2):
        assert torch.equal(poses[b], batch.vo_scan(g[b], d[b], tcfg)[0])
    with pytest.raises(NotImplementedError, match="P13"):
        batch.vo_scan_batched(g, d, tcfg, mesh=object())
