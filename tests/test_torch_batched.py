"""The port's batched step: one lane axis through build_frame, make_keyframe,
the solvers, track_frames, track_ring, verify_candidates_batched and
vo_scan_batched, at 160x120 with B = 3 on the CPU (plain kernel versions).

Every lane of a batched call is bit-equal to the same lane run alone
(B = 1), and permuting the lanes permutes every output bit for bit.
Against the JAX package's vmapped functions on the same numpy inputs, the
tolerances of tests/test_torch_slice.py and tests/test_torch_scan.py:
edges, counts and cloud slot order bit-equal, cloud points within rtol
1e-6; per-frame poses within 1e-5 m / 1e-5 rad for one track, 1e-4 for a
whole scan; flags and verdicts equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import loopclosure as jloop
from revo_tpu import tracker as jtracker
from revo_tpu.parallel import batch as jbatch
from revo_tpu_torch import convert, frontend, lanes, lie, loopclosure, solver, tracker
from revo_tpu_torch.config import CameraConfig
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.ops import lgsx
from revo_tpu_torch.ops.backproject import EdgeCloud, compact
from revo_tpu_torch.parallel import batch

from _torch_inputs import CAM, EDGE_DISTANCE, HUBER, make_inputs, make_pose
from test_solver import small_cfg
from test_torch_vo import assert_poses_close, pan_sequence, rot_angle

torch.set_num_threads(1)

B = 3
POSE_TOL = 1e-5  # one track against JAX (tests/test_torch_slice.py)
SCAN_TOL = 1e-4  # a whole scan against JAX (tests/test_torch_scan.py)


def _cfg(solver_name="lm", **tracker_fields):
    cfg = small_cfg()
    opt = dataclasses.replace(cfg.tracker.optimizer, solver=solver_name)
    trk = dataclasses.replace(cfg.tracker, optimizer=opt, **tracker_fields)
    return dataclasses.replace(cfg, tracker=trk)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def assert_lane_equal(batched, single, i):
    """Lane ``i`` of a batched NamedTuple tree bit-equal to a one-lane one."""
    got, want = _leaves(lanes.lane(batched, i)), _leaves(single)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def seq():
    """Four frames of a seeded trajectory (tests/test_torch_slice.py)."""
    cam = small_cfg().camera
    scene = tsyn.SyntheticScene()
    traj = scene.trajectory(4, seed=3)
    frames = [tsyn.render_frame(scene, cam, T, seed=3000 + i) for i, T in enumerate(traj)]
    gray = np.stack([g.astype(np.uint8) for g, _ in frames])
    depth = np.stack([(d * 5000.0).astype(np.uint16) for _, d in frames])
    return gray, depth, traj


@pytest.fixture(scope="module")
def port(seq):
    """The port's batched frames 1..3 and keyframe of frame 0."""
    gray, depth, _ = seq
    tcfg = convert.config_from_jax(_cfg())
    g, d = torch.from_numpy(gray), torch.from_numpy(depth)
    frames = frontend.build_frame_batched(g[1:], d[1:], tcfg)
    kf = frontend.make_keyframe(frontend.build_frame(g[0], d[0], tcfg), torch.eye(4), tcfg)
    return tcfg, g, d, frames, kf


def test_build_frame_lanes_bit_equal(port):
    tcfg, g, d, frames, _ = port
    for i in range(B):
        assert_lane_equal(frames, frontend.build_frame(g[1 + i], d[1 + i], tcfg), i)
    perm = [2, 0, 1]
    permuted = frontend.build_frame_batched(g[1:][perm], d[1:][perm], tcfg)
    for j, i in enumerate(perm):
        assert_lane_equal(permuted, lanes.lane(frames, i), j)


def test_make_keyframe_lanes_bit_equal(port):
    tcfg, _, _, frames, _ = port
    poses = lie.matrix_from_rt(*lie.exp_se3(torch.tensor(
        np.random.default_rng(0).normal(scale=0.05, size=(B, 6)).astype(np.float32))))
    kfs = frontend.make_keyframe_batched(frames, poses, tcfg)
    for i in range(B):
        one = frontend.make_keyframe(lanes.lane(frames, i), poses[i], tcfg)
        assert_lane_equal(kfs, one, i)


def test_compact_lanes_bit_equal():
    """Three masks: sparse, exactly at capacity, and overflowing (slots by
    the stride decimation)."""
    rng = np.random.default_rng(1)
    cap = 500
    masks = np.zeros((B, 60, 80), bool)
    masks[0].flat[rng.choice(4800, 200, replace=False)] = True
    masks[1].flat[rng.choice(4800, cap, replace=False)] = True
    masks[2].flat[rng.choice(4800, 2000, replace=False)] = True
    m = torch.from_numpy(masks)
    got = compact(m, cap)
    assert [int(c) for c in got[2]] == [200, cap, 2000]
    for i in range(B):
        assert_lane_equal(got, compact(m[i], cap), i)
    perm = [1, 2, 0]
    permuted = compact(m[perm], cap)
    for j, i in enumerate(perm):
        assert_lane_equal(permuted, lanes.lane(got, i), j)


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_track_frames_lanes_bit_equal(port, solver_name, monkeypatch):
    """Lane 0 starts at the pose its own track converged to (it stops at
    once), lane 1 at identity, lane 2 perturbed: the lanes stop at
    different evaluations, and the stopped ones are frozen."""
    _, g, d, frames, kf = port
    tcfg = convert.config_from_jax(_cfg(solver_name))
    f0 = lanes.lane(frames, 0)
    done = tracker.track_frames(kf, f0, torch.eye(3), torch.zeros(3), tcfg)
    dR, dt = lie.exp_se3(torch.tensor([0.01, -0.008, 0.006, 0.004, -0.003, 0.005]))
    R0 = torch.stack([done.R, torch.eye(3), dR])
    t0 = torch.stack([done.t, torch.zeros(3), dt])
    evaluated = []
    real = lgsx.residual_lgsx_lanes

    def counted(*args, **kw):
        active = args[6] if len(args) > 6 else kw.get("active")
        evaluated.append([True] * B if active is None else active.tolist())
        return real(*args, **kw)

    monkeypatch.setattr(solver, "residual_lgsx_lanes", counted)
    kf_b = lanes.add_lane_axis(kf._replace(frame=None), B)
    res = tracker.track_frames_batched(kf_b, frames, R0, t0, tcfg)
    monkeypatch.undo()
    per_lane = np.sum(evaluated, axis=0)
    assert len(set(per_lane.tolist())) > 1, per_lane  # the lanes stopped apart
    for i in range(B):
        assert_lane_equal(res, tracker.track_frames(kf, lanes.lane(frames, i), R0[i], t0[i],
                                                    tcfg), i)
    perm = [2, 0, 1]
    permuted = tracker.track_frames_batched(
        kf_b, lanes.stack_lanes([lanes.lane(frames, i) for i in perm]), R0[perm],
        t0[perm], tcfg)
    for j, i in enumerate(perm):
        assert_lane_equal(permuted, lanes.lane(res, i), j)


def test_track_frames_linalg_solve_lanes_close(port):
    """``solve6_impl="linalg"``: a batched ``torch.linalg.solve`` may take
    another kernel per batch size, so lanes are held to B = 1 within the
    slice's pose tolerance, not by bits."""
    _, _, _, frames, kf = port
    cfg = _cfg("gn_fixed")
    opt = dataclasses.replace(cfg.tracker.optimizer, solve6_impl="linalg")
    tcfg = convert.config_from_jax(
        dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt)))
    res = tracker.track_frames_batched(
        lanes.add_lane_axis(kf._replace(frame=None), B), frames,
        torch.eye(3).expand(B, 3, 3), torch.zeros(B, 3), tcfg)
    for i in range(B):
        one = tracker.track_frames(kf, lanes.lane(frames, i), torch.eye(3), torch.zeros(3),
                                   tcfg)
        assert float((res.t[i] - one.t).abs().max()) <= POSE_TOL
        assert rot_angle(res.R[i].numpy(), one.R.numpy()) <= POSE_TOL


def test_residual_lgsx_ref_shared_cloud():
    """One cloud shared by three lanes (stride 0) against three quad
    tables at three poses, as track_ring runs it; an inactive lane's row of
    ``out`` is left as it was."""
    quads, poses = [], [make_pose(k) for k in ("identity", "tracked", "out")]
    for seed in range(B):
        quads.append(torch.from_numpy(make_inputs(seed, 700, "dt4bf")[0]).to(torch.bfloat16))
    _, pts, valid = make_inputs(7, 700, "dt4bf")
    cloud = EdgeCloud(torch.from_numpy(pts), torch.from_numpy(valid), None)
    cam = CameraConfig(**CAM)
    R = torch.from_numpy(np.stack([p[0] for p in poses]))
    t = torch.from_numpy(np.stack([p[1] for p in poses]))
    shared = EdgeCloud(*(lanes.add_lane_axis(x, B) for x in cloud[:2]), None)
    out = torch.full((B, 46), -7.0)
    active = torch.tensor([True, False, True])
    got = lgsx.residual_lgsx_batched(torch.stack(quads), shared, cam, R, t, EDGE_DISTANCE,
                                     HUBER, True, active, out)
    assert bool((out[1] == -7.0).all())
    for i in (0, 2):
        want = lgsx.residual_lgsx_ref(quads[i], cloud, cam, R[i], t[i], EDGE_DISTANCE,
                                      HUBER, True)
        for a, b in zip(got, want):
            assert torch.equal(a[i], b)
    assert int(got[5][2]) > int(got[4][2])  # the "out" pose throws most points out


def _jax_frames_batched(gray, depth, cfg):
    return jax.vmap(lambda g, d: jfront.build_frame(g, d, cfg))(
        jnp.asarray(gray), jnp.asarray(depth))


def test_build_frame_matches_jax_vmap(seq, port):
    gray, depth, _ = seq
    _, _, _, frames, _ = port
    fj = _jax_frames_batched(gray[1:], depth[1:], _cfg())
    for lj, lt in zip(fj.levels, frames.levels):
        for name in ("gray", "depth", "edges", "edges_orig"):
            np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
        np.testing.assert_array_equal(lt.cloud.valid.numpy(), np.asarray(lj.cloud.valid))
        np.testing.assert_array_equal(lt.cloud.count.numpy(), np.asarray(lj.cloud.count))
        np.testing.assert_allclose(lt.cloud.points.numpy(), np.asarray(lj.cloud.points),
                                   rtol=1e-6, atol=0)


def test_track_frames_matches_jax_vmap_gn_fixed(seq, port):
    gray, depth, _ = seq
    _, _, _, frames, kf = port
    cfg = _cfg("gn_fixed")
    tcfg = convert.config_from_jax(cfg)
    fj = _jax_frames_batched(gray, depth, cfg)
    kj = jfront.make_keyframe(jax.tree.map(lambda x: x[0], fj), jnp.eye(4), cfg)
    fj_rest = jax.tree.map(lambda x: x[1:], fj)
    rj = jax.vmap(lambda f: jtracker.track_frames(kj, f, jnp.eye(3), jnp.zeros(3), cfg))(fj_rest)
    rt = tracker.track_frames_batched(
        lanes.add_lane_axis(kf._replace(frame=None), B), frames,
        torch.eye(3).expand(B, 3, 3), torch.zeros(B, 3), tcfg)
    for i in range(B):
        assert float(np.abs(rt.t[i].numpy() - np.asarray(rj.t[i])).max()) <= POSE_TOL
        assert rot_angle(rt.R[i].numpy(), np.asarray(rj.R[i])) <= POSE_TOL
    np.testing.assert_array_equal(rt.good.numpy(), np.asarray(rj.good))
    np.testing.assert_array_equal(rt.new_kf.numpy(), np.asarray(rj.new_kf))


@pytest.fixture(scope="module")
def teleport():
    """tests/test_relocalization.py's sequence (12 frames, seed 11) and
    frame 0's view again: the keyframes of frames 0, 4 and 8 fill a ring,
    the last frame is the one to relocalize."""
    cam = small_cfg().camera
    scene = tsyn.SyntheticScene()
    seq = list(tsyn.render_sequence(scene, cam, 12, seed=11))
    g0, d0 = tsyn.render_frame(scene, cam, seq[0][2])
    gray = np.stack([seq[i][0] for i in (0, 4, 8)] + [g0]).astype(np.uint8)
    depth = np.stack([(seq[i][1] * 5000.0).astype(np.uint16) for i in (0, 4, 8)]
                     + [(d0 * 5000.0).astype(np.uint16)])
    poses = np.stack([seq[i][2] for i in (0, 4, 8)]).astype(np.float32)
    return gray, depth, poses


def test_track_ring_matches_jax(teleport):
    gray, depth, poses = teleport
    cfg = _cfg()
    tcfg = convert.config_from_jax(cfg)
    k = tcfg.tracker.kf_history_size
    g, d = torch.from_numpy(gray), torch.from_numpy(depth)
    ft = frontend.build_frame_batched(g, d, tcfg)
    kts = frontend.make_keyframe_batched(ft, _pad_poses(poses), tcfg)
    ring = tracker.ring_from_keyframe(lanes.lane(kts, 0), k)
    for i in (1, 2):
        ring = tracker.push_ring(ring, lanes.lane(kts, i), torch.from_numpy(poses[i]))
    frame = lanes.lane(ft, 3)
    rt = tracker.track_ring(ring, frame, tcfg)
    eye, zero = torch.eye(3), torch.zeros(3)
    for slot in range(ring.n):  # batched slots equal the per-slot tracks
        one = tracker.track_frames(tracker.ring_keyframe(ring, slot, frame), frame, eye, zero,
                                   tcfg)
        assert_lane_equal(rt, one, slot)
    assert bool(torch.isinf(rt.error[ring.n:]).all())

    fj = _jax_frames_batched(gray, depth, cfg)
    kjs = [jfront.make_keyframe(jax.tree.map(lambda x, i=i: x[i], fj), jnp.asarray(poses[i]),
                                cfg) for i in range(3)]
    rj_ring = jtracker.ring_from_keyframe(kjs[0], k)
    for i in (1, 2):
        rj_ring = jtracker.push_ring(rj_ring, kjs[i], jnp.asarray(poses[i]))
    rj = jtracker.track_ring(rj_ring, jax.tree.map(lambda x: x[3], fj), cfg)
    found_j, idx_j, _ = jtracker.select_reloc_candidate(rj, rj_ring.n, cfg)
    found_t, idx_t, _ = tracker.select_reloc_candidate(rt, ring.n, tcfg)
    assert bool(found_t) and bool(found_j) and int(idx_t) == int(idx_j) == 2
    for slot in range(ring.n):
        assert float(np.abs(rt.t[slot].numpy() - np.asarray(rj.t[slot])).max()) <= POSE_TOL
        assert rot_angle(rt.R[slot].numpy(), np.asarray(rj.R[slot])) <= POSE_TOL
        assert int(rt.good[slot]) == int(rj.good[slot])


def _pad_poses(poses):
    """The three keyframe poses and one more row for the teleport frame,
    which is built with the keyframes but never made one."""
    return torch.from_numpy(np.concatenate([poses, np.eye(4, dtype=np.float32)[None]]))


@pytest.fixture(scope="module")
def three_sequences():
    """16 frames each: a teleport back to frame 0's view at frame 14 (the
    ring relocalizes it), the fast pan (promotes at frame 12), and a slow
    random trajectory (neither), under scan relocalization with a jump gate
    between the pan's 4 cm steps and the teleport."""
    cfg = _cfg(scan_relocalization=True, max_jump_translation=0.07)
    cam = cfg.camera
    scene = tsyn.SyntheticScene()
    seq = list(tsyn.render_sequence(scene, cam, 14, seed=11))
    g0, d0 = tsyn.render_frame(scene, cam, seq[0][2])
    tel = [f[0] for f in seq] + [g0] * 2, [f[1] for f in seq] + [d0] * 2
    pan, _ = pan_sequence(cam, 16)
    slow = list(tsyn.render_sequence(scene, cam, 16, seed=5))
    grays = np.stack([np.stack(tel[0]), np.stack([f[0] for f in pan]),
                      np.stack([f[0] for f in slow])])
    depths = np.stack([np.stack(tel[1]), np.stack([f[1] for f in pan]),
                       np.stack([f[1] for f in slow])])
    return cfg, grays, depths


def _flags(outs):
    return np.stack([np.asarray(outs.promoted), np.asarray(outs.relocalized),
                     np.asarray(outs.lost)], axis=-1)


def test_vo_scan_batched_lanes_and_jax(three_sequences):
    cfg, grays, depths = three_sequences
    tcfg = convert.config_from_jax(cfg)
    g, d = torch.from_numpy(grays), torch.from_numpy(depths)
    outs, states = batch.vo_scan_lanes(g, d, tcfg)
    flags = _flags(outs)
    assert np.flatnonzero(flags[0, :, 1]).tolist() == [14]  # lane 0 relocalizes
    assert np.flatnonzero(flags[1, :, 0]).tolist() == [12]  # lane 1 promotes
    assert not flags[2].any() and not flags[..., 2].any()
    assert torch.equal(batch.vo_scan_batched(g, d, tcfg), outs.T_w)
    for i in range(B):
        p, o, s = batch.vo_scan(g[i], d[i], tcfg)
        assert_lane_equal(outs, o, i)
        assert (s.n_keyframes, s.past.n, s.kf_ring.n) == (
            states[i].n_keyframes, states[i].past.n, states[i].kf_ring.n)
    oj = jax.jit(jax.vmap(lambda g_, d_: jbatch.vo_scan(g_, d_, cfg)[1]))(
        jnp.asarray(grays), jnp.asarray(depths))
    np.testing.assert_array_equal(flags, _flags(oj))
    for i in range(B):
        assert_poses_close(outs.T_w[i].numpy().astype(np.float64),
                           np.asarray(oj.T_w[i]).astype(np.float64), tol=SCAN_TOL)


def test_verify_candidates_batched_matches_jax():
    """Pan keyframes at frames 0, 3, 6 and 9 with their true poses, the
    third one perturbed by a centimetre and the fourth by decimetres (its
    pairs fail): every pair verified as one batch, each pair bit-equal to
    its own verify_candidate, verdicts equal to JAX's."""
    cfg = small_cfg()
    tcfg = convert.config_from_jax(cfg)
    frames, gt = pan_sequence(cfg.camera, 10)
    idx = [0, 3, 6, 9]
    gray = np.stack([frames[i][0] for i in idx])
    depth = np.stack([frames[i][1] for i in idx])
    poses = gt[idx].astype(np.float32)
    poses[2, :3, 3] += np.array([0.01, -0.005, 0.0], np.float32)
    poses[3, :3, 3] += np.array([0.2, -0.1, 0.05], np.float32)  # too far off to verify
    ft = frontend.build_frame_batched(torch.from_numpy(gray), torch.from_numpy(depth), tcfg)
    kb = frontend.make_keyframe_batched(ft, torch.from_numpy(poses), tcfg)
    kts = [lanes.lane(kb, i) for i in range(4)]
    cands = [(0, 1), (0, 2), (1, 3), (0, 3)]
    got = loopclosure.verify_candidates_batched(kts, cands, tcfg)
    for (a, b), v in zip(cands, got):
        one = loopclosure.verify_candidate(kts[a], kts[b], tcfg)
        assert (v is None) == (one is None)
        if v is not None:
            assert np.array_equal(v[0], one[0]) and v[1] == one[1]
    assert any(v is not None for v in got) and any(v is None for v in got)

    fj = _jax_frames_batched(gray, depth, cfg)
    kjs = [jfront.make_keyframe(jax.tree.map(lambda x, i=i: x[i], fj), jnp.asarray(poses[i]),
                                cfg) for i in range(4)]
    want = jloop.verify_candidates_batched(kjs, cands, cfg)
    assert [v is None for v in got] == [v is None for v in want]
    for v, w in zip(got, want):
        if v is not None:
            assert_poses_close(v[0][None].astype(np.float64), np.asarray(w[0])[None], POSE_TOL)
