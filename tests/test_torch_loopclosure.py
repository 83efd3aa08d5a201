"""The port's loop closure (revo_tpu_torch.loopclosure, the online form in
system.VOSystem) against the JAX package's, on the four loop keyframes of
tests/test_loopclosure.py at 160x120 (CPU, plain kernel versions); its cases,
then the same inputs through both packages.

Tolerances: candidate lists identical; verdicts identical (the pairs sit
away from the acceptance thresholds: errors 0.125-0.235 against 0.3 and
0.2, inliers 2330+ against 300, ratios 2.5+ against 2); verified T_ab
within 1e-4 m / 1e-4 rad and its error within 1e-4; corrected poses within
1e-4 after 15 GN iterations; after an online closure the live state (anchors,
rings, keyframe poses) within 1e-4 of JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import loopclosure as jlc
from revo_tpu import system as jsystem
from revo_tpu import tracker as jtracker
from revo_tpu_torch import convert, frontend, loopclosure as lc, system, tracker
from revo_tpu_torch.io import synthetic as tsyn

from test_loopclosure import _loop_keyframes
from test_torch_vo import assert_poses_close

torch.set_num_threads(1)

TOL = 1e-4
PAIRS = [(0, 2), (0, 3), (1, 3)]


@pytest.fixture(scope="module")
def loop():
    """(JAX cfg, port cfg, JAX keyframes, the same keyframes carried into
    the port, ground truth, drifted estimates)."""
    cfg, kfs, gt, drifted = _loop_keyframes()
    tk = [convert.keyframe_from_numpy(jax.tree.map(np.asarray, k), device="cpu") for k in kfs]
    return cfg, convert.config_from_jax(cfg), kfs, tk, gt, drifted


@pytest.fixture(scope="module")
def closed(loop):
    cfg, tcfg, kfs, tk, _, _ = loop
    return (jlc.close_loops(kfs, cfg, min_separation=2, radius=0.3),
            lc.close_loops(tk, tcfg, min_separation=2, radius=0.3))


def _same_verdicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert_poses_close(g[0][None], w[0][None], TOL)
            assert abs(g[1] - w[1]) < TOL


def test_find_candidates_matches_jax():
    eye = np.eye(4, dtype=np.float32)
    far, near = eye.copy(), eye.copy()
    far[:3, 3] = [5, 0, 0]
    near[:3, 3] = [0.1, 0, 0]
    cands = lc.find_candidates([eye, far, far, near], min_separation=2, radius=0.5)
    assert (0, 3) in cands and all(b - a > 2 for a, b in cands)
    assert lc.find_candidates([eye]) == []
    rng = np.random.default_rng(0)
    for k, sep, radius, cap in ((12, 2, 0.5, 20), (30, 1, 0.8, 7), (5, 0, 2.0, 20)):
        poses = np.tile(eye, (k, 1, 1))
        poses[:, :3, 3] = rng.normal(scale=0.4, size=(k, 3))
        want = jlc.find_candidates(list(poses), sep, radius, cap)
        assert lc.find_candidates(list(poses), sep, radius, cap) == want
        assert len(want) > 0


def test_drifted_loop_recovers_like_jax(loop, closed):
    *_, gt, drifted = loop
    (cj, lj), (corrected, loops) = closed
    assert [(e.a, e.b) for e in loops] == [(e.a, e.b) for e in lj] == [(0, 3)]
    for e, ej in zip(loops, lj):
        # The verified relative pose matches ground truth despite the
        # drifted initialization (the imagery is undrifted), and JAX's.
        d = np.linalg.inv(e.T_ab) @ np.linalg.inv(gt[e.a]) @ gt[e.b]
        assert np.linalg.norm(d[:3, 3]) < 0.015
        assert_poses_close(e.T_ab[None], ej.T_ab[None], TOL)
        assert abs(e.error - ej.error) < TOL
    derr = np.linalg.norm(drifted[3, :3, 3] - gt[3, :3, 3])
    cerr = np.linalg.norm(corrected[3, :3, 3] - gt[3, :3, 3])
    assert cerr < 0.6 * derr
    assert corrected.dtype == np.float32
    assert_poses_close(corrected, cj, TOL)


def test_reanchor_uses_kf_ordinals(loop, closed):
    *_, drifted = loop
    (cj, _), (corrected, _) = closed
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.01, 0.0, 0.0]
    graph = [system.PoseNode(T_kf_curr=rel, T_w_kf=drifted[i], timestamp=float(i), kf_ordinal=i)
             for i in range(4)]
    traj = lc.reanchor_trajectory(graph, corrected)
    np.testing.assert_allclose(traj, np.einsum("kij,jl->kil", corrected, rel), atol=1e-6)
    np.testing.assert_allclose(traj, jlc.reanchor_trajectory(graph, cj), atol=TOL)


def test_no_candidates_is_identity(loop):
    _, tcfg, _, tk, _, drifted = loop
    poses, loops = lc.close_loops(tk, tcfg, radius=1e-6)
    np.testing.assert_array_equal(poses, drifted)
    assert loops == []


@pytest.mark.parametrize("max_error", [0.3, 0.2])
def test_verdicts_match_serial_and_jax(loop, max_error):
    """All admissible pairs; at max_error 0.2 the verifier rejects (0, 2)
    (error 0.235) on both sides.  The batched form returns what the serial
    one returns."""
    cfg, tcfg, kfs, tk, _, _ = loop
    serial = [lc.verify_candidate(tk[a], tk[b], tcfg, max_error=max_error) for a, b in PAIRS]
    batched = lc.verify_candidates_batched(tk, PAIRS, tcfg, max_error=max_error)
    _same_verdicts(batched, serial)
    _same_verdicts(batched, jlc.verify_candidates_batched(kfs, PAIRS, cfg, max_error=max_error))
    assert [v is None for v in batched] == [max_error < 0.235, False, False]


def test_empty_candidates_and_mesh_form(loop):
    _, tcfg, _, tk, _, _ = loop
    assert lc.verify_candidates_batched(tk, [], tcfg) == []
    with pytest.raises(TypeError, match="Mesh"):
        lc.verify_candidates_batched(tk, PAIRS, tcfg, mesh=object())


def test_pruned_keyframes_verify_alike(loop, closed):
    """Retained keyframes are pruned; verification reads structs, quads and
    clouds only."""
    _, tcfg, _, tk, _, _ = loop
    corrected, loops = lc.close_loops(
        [frontend.prune_keyframe(k) for k in tk], tcfg, min_separation=2, radius=0.3)
    np.testing.assert_array_equal(corrected, closed[1][0])
    assert [(e.a, e.b) for e in loops] == [(0, 3)]


def _install_loop(vo, keyframes, tr):
    """Put the four loop keyframes into a running VOSystem as its retained
    history, relocalization ring and current keyframe, and anchor its three
    pose-graph nodes to keyframes 0, 1 and 3."""
    vo.kf_history = list(enumerate(keyframes))
    vo.n_keyframes = len(keyframes)
    vo.kf, vo.kf_ordinal_current = keyframes[-1], len(keyframes) - 1
    ring = tr.ring_from_keyframe(keyframes[0], vo.cfg.tracker.kf_history_size)
    for kf in keyframes[1:]:
        ring = tr.push_ring(ring, kf, kf.T_w_k)
    vo.reloc_ring = ring
    for node, o in zip(vo.pose_graph, (0, 1, 3)):
        node.kf_ordinal = o
        node.T_w_kf = np.asarray(keyframes[o].T_w_k)
    vo.just_added_kf = True  # no promotion on the next frame
    vo.T_nm1_n = np.eye(4, dtype=np.float32)


def _live_state(vo):
    arr = np.asarray
    return {
        "kf": arr(vo.kf.T_w_k)[None],
        "history": np.stack([arr(kf.T_w_k) for _, kf in vo.kf_history]),
        "anchors": np.stack([n.T_w_kf for n in vo.pose_graph]),
        "poses": np.stack([n.T_w_curr for n in vo.pose_graph]),
        "past": arr(vo.past.poses),
        "voting": arr(vo.past_voting.poses),
        "ring": arr(vo.reloc_ring.T_w_k),
    }


def test_online_loop_closure_matches_jax(loop):
    """VOSystem with online_loop_closure on both sides: three frames of a
    handheld sequence give a live state, the loop keyframes become its
    history, and the closure runs once by hand and once through
    process_frame's trigger (loop_closure_every = 1): the same number of
    accepted edges each time, and the corrected live state (retained
    keyframes, anchors, current keyframe, past and voting rings,
    relocalization ring) and the next frame's pose within 1e-4."""
    cfg, _, kfs, tk, gt, drifted = loop
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, online_loop_closure=True, loop_closure_every=1))
    tcfg = convert.config_from_jax(cfg)
    scene = tsyn.SyntheticScene()
    seq = list(tsyn.render_sequence(scene, cfg.camera, 3, seed=2))
    step = np.eye(4, dtype=np.float32)
    step[:3, 3] = [0.01, 0.0, 0.005]
    g4, d4 = tsyn.render_frame(scene, cfg.camera, gt[3] @ step)

    vj, vt = jsystem.VOSystem(cfg), system.VOSystem(tcfg, device="cpu")
    states, edges, last = [], [], []
    for vo, keyframes, tr, to_dev in ((vj, kfs, jtracker, jnp.asarray),
                                      (vt, tk, tracker, torch.from_numpy)):
        counts = []
        inner = vo._online_loop_closure
        vo._online_loop_closure = lambda inner=inner, counts=counts: counts.append(inner())
        for g, d, _, ts in seq:
            vo.process_frame(g, d, ts)
        assert counts == [0, 0]  # frames 1 and 2: < 3 keyframes retained
        _install_loop(vo, keyframes, tr)
        vo.R, vo.t = to_dev(np.eye(3, dtype=np.float32)), to_dev(np.zeros(3, np.float32))
        before = _live_state(vo)
        n_edges = inner()
        after = _live_state(vo)
        last.append(np.asarray(vo.process_frame(g4, d4, 1.0), np.float64))
        states.append((before, after, _live_state(vo)))
        edges.append((n_edges, counts[-1]))
    assert edges[0] == edges[1] == (1, 1)
    (bj, aj, fj), (bt, at, ft) = states
    for name in bj:
        np.testing.assert_allclose(bt[name], bj[name], rtol=0, atol=TOL, err_msg=name)
        assert_poses_close(at[name], aj[name], TOL)
        assert_poses_close(ft[name], fj[name], TOL)
    # The correction moved the live state: keyframe 3 and what hangs on it.
    for name in ("kf", "history", "anchors", "past", "voting", "ring"):
        assert np.abs(at[name] - bt[name]).max() > 5e-3, name
    np.testing.assert_array_equal(at["history"][0], bt["history"][0])  # gauge
    np.testing.assert_array_equal(at["ring"][:4], at["history"][::-1])
    assert_poses_close(last[1][None], last[0][None], TOL)
    # Tracking survives the correction: the new frame lands near truth.
    assert np.linalg.norm(last[1][:3, 3] - (gt[3] @ step)[:3, 3]) < 0.03
