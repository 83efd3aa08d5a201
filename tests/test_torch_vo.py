"""The port's keyframe selection, relocalization ring and VOSystem host loop
against the JAX package's, on the same seeded synthetic frames at 160x120
(CPU, plain kernel versions; JAX jitted on the CPU as its own tests run it).

Tolerances: ring pushes bit-equal; the voting counting map M and new_kf
bit-equal; select_reloc_candidate's (found, idx) and selected result equal;
VOSystem per-frame promotion / relocalization / lost flags identical and
world poses within 1e-4 m and 1e-4 rad of JAX's.

``pan_sequence`` and ``run_host`` are shared with test_torch_scan.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import system as jsystem
from revo_tpu import tracker as jtracker
from revo_tpu import frontend as jfront
from revo_tpu_torch import convert, frontend, lie, system, tracker
from revo_tpu_torch.io import synthetic as tsyn

from test_solver import small_cfg

torch.set_num_threads(1)

POSE_TOL = 1e-4  # metres and radians


def pan_sequence(cam, n=25):
    """tests/test_system.py's fast lateral pan (4 cm + ~1 deg per frame),
    rendered once: (frames [(gray, depth, ts)], ground truth (n, 4, 4))."""
    scene = tsyn.SyntheticScene()
    xi = torch.tensor([0.04, 0.0, 0.005, 0.0, 0.017, 0.0])
    step = lie.matrix_from_rt(*lie.exp_se3(xi)).numpy()
    T = np.eye(4, dtype=np.float32)
    frames, gt = [], []
    for i in range(n):
        g, d = tsyn.render_frame(scene, cam, T)
        frames.append((g, d, i / 30.0))
        gt.append(T.copy())
        T = T @ step
    return frames, np.stack(gt)


def counters(vo):
    return np.array([vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost])


def run_host(vo, frames):
    """process_frame over ``frames``; returns (poses (N, 4, 4), per-frame
    (promoted, relocalized, lost) counter increments (N, 3))."""
    poses, flags = [], []
    for g, d, ts in frames:
        before = counters(vo)
        poses.append(np.asarray(vo.process_frame(g, d, ts), np.float64))
        flags.append(counters(vo) - before)
    return np.stack(poses), np.stack(flags)


def rot_angle(Ra, Rb) -> float:
    D = Ra.T.astype(np.float64) @ Rb.astype(np.float64)
    s = np.linalg.norm(D - D.T) / (2 * np.sqrt(2))
    return float(np.arctan2(s, (np.trace(D) - 1.0) / 2.0))


def assert_poses_close(a, b, tol=POSE_TOL):
    dt = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    dr = max(rot_angle(x[:3, :3], y[:3, :3]) for x, y in zip(a, b))
    assert dt <= tol and dr <= tol, f"poses differ by {dt} m, {dr} rad"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cfgs():
    cfg = small_cfg()
    return cfg, convert.config_from_jax(cfg)


@pytest.fixture(scope="module")
def pan(cfgs):
    return pan_sequence(cfgs[0].camera)


@pytest.fixture(scope="module")
def pan_frames(cfgs, pan):
    """JAX frames of the first 21 pan frames and their ground truth."""
    cfg = cfgs[0]
    frames, gt = pan
    return [jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
            for g, d, _ in frames[:21]], gt


# -- rings ----------------------------------------------------------------------


def test_push_past_matches_jax():
    rng = np.random.default_rng(0)
    k, p = 3, 64
    pj = jtracker.empty_past(k, p)
    pt = tracker.empty_past(k, p, "cpu")
    for _ in range(k + 2):
        pts = rng.normal(size=(p, 3)).astype(np.float32)
        valid = rng.random(p) < 0.7
        pose = rng.normal(size=(4, 4)).astype(np.float32)
        pj = jtracker.push_past(pj, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose))
        pt = tracker.push_past(pt, torch.from_numpy(pts), torch.from_numpy(valid),
                               torch.from_numpy(pose))
        assert pt.n == int(pj.n)
        for name in ("points", "valid", "poses"):
            np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                          np.asarray(getattr(pj, name)))
    assert pt.n == k


def test_push_ring_matches_jax(cfgs, pan_frames):
    cfg, tcfg = cfgs
    frames, gt = pan_frames
    kfs = [jfront.make_keyframe(frames[i], jnp.asarray(gt[i]), cfg) for i in (0, 4, 8)]
    k = cfg.tracker.kf_history_size
    rj = jtracker.ring_from_keyframe(kfs[0], k)
    rt = tracker.ring_from_keyframe(convert.keyframe_from_numpy(_np_tree(kfs[0])), k)
    for i in range(k + 2):
        kj = kfs[(i + 1) % 3]
        pose = gt[i + 1]
        rj = jtracker.push_ring(rj, kj, jnp.asarray(pose))
        rt = tracker.push_ring(rt, convert.keyframe_from_numpy(_np_tree(kj)),
                               torch.from_numpy(pose))
        assert rt.n == int(rj.n)
        np.testing.assert_array_equal(rt.T_w_k.numpy(), np.asarray(rj.T_w_k))
        for a, b in zip(rt.structs + rt.quads, rj.structs + rj.quads):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b).astype(np.float32))
    assert rt.n == k
    # The converter carries the same ring across.
    rc = convert.ring_from_numpy(_np_tree(rj))
    assert rc.n == rt.n and all(torch.equal(a, b) for a, b in zip(rc.quads, rt.quads))


@pytest.mark.parametrize("counts, caps", [
    ((900, 300, 100), (4096, 2048, 1024)),
    ((3000, 1200, 500), (4096, 2048, 1024)),
    ((5000, 100, 100), (4096, 2048, 1024)),
    ((10, 10), (256, 300)),
])
def test_pick_buckets_matches_jax(counts, caps):
    assert tracker.pick_buckets(counts, caps) == jtracker.pick_buckets(counts, caps)


def test_track_frames_bucketed_matches_track_frames(cfgs, pan_frames):
    """Slicing away padding lanes changes only the reduction order."""
    cfg, tcfg = cfgs
    frames, gt = pan_frames
    kf = convert.keyframe_from_numpy(_np_tree(jfront.make_keyframe(frames[0], jnp.eye(4), cfg)))
    ft = convert.frame_from_numpy(_np_tree(frames[2]))
    eye, zero = torch.eye(3), torch.zeros(3)
    full = tracker.track_frames(kf, ft, eye, zero, tcfg)
    bucketed = tracker.track_frames_bucketed(kf, ft, eye, zero, tcfg)
    caps = [lv.cloud.points.shape[0] for lv in ft.levels]
    sliced = tracker.slice_cloud_frame(ft, tracker.pick_buckets(
        [int(lv.cloud.count) for lv in ft.levels], caps))
    assert [lv.cloud.points.shape[0] for lv in sliced.levels] < caps
    assert all(torch.equal(a.cloud.valid[: b.cloud.valid.shape[0]], b.cloud.valid)
               and int(a.cloud.valid.sum()) == int(b.cloud.valid.sum())
               for a, b in zip(ft.levels, sliced.levels))
    assert_poses_close(lie.matrix_from_rt(bucketed.R, bucketed.t)[None].numpy(),
                       lie.matrix_from_rt(full.R, full.t)[None].numpy(), tol=1e-5)


# -- histogram voting -----------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_counting_map(past, est_pose_w, cfg):
    """The counting map M of revo_tpu/tracker.py::assess_tracking_quality
    (tracker.py:331-358), which that function does not return."""
    lvl = cfg.tracker.histogram_level
    cam = cfg.camera_pyramid()[lvl]
    h, w = cam.height, cam.width
    k = past.points.shape[0]
    inv_est = jnp.linalg.inv(est_pose_w)

    def project_one(slot):
        T = inv_est @ past.poses[slot]
        R, t = T[:3, :3], T[:3, 3]
        wxp = jnp.matmul(past.points[slot], R.T, precision=jax.lax.Precision.HIGHEST) + t
        pz = jnp.where(wxp[:, 2] == 0, 1e-12, wxp[:, 2])
        u = wxp[:, 0] / pz * cam.fx + cam.cx
        v = wxp[:, 1] / pz * cam.fy + cam.cy
        inb = (u >= 0) & (v >= 0) & (u < w) & (v < h) & past.valid[slot]
        inb = inb & (slot < past.n)
        lin = jnp.floor(v).astype(jnp.int32) * w + jnp.floor(u).astype(jnp.int32)
        lin = jnp.where(inb, lin, h * w)
        m_i = jnp.zeros(h * w + 1, jnp.int32).at[lin].max(jnp.where(inb, 1, 0))
        return m_i[: h * w]

    return jnp.sum(jax.vmap(project_one)(jnp.arange(k)), axis=0).reshape(h, w)


# (past frame indices, current frame, perturbation of its true pose)
VOTING_CASES = [
    ((0, 1, 2), 3, 0.0),
    ((0, 1, 2), 2, 0.0),  # est pose == slot 2's pose: points land on pixel corners
    ((0, 1, 2), 8, 2e-3),
    ((0, 1, 2), 14, 0.0),
    ((0, 1, 2), 20, 1e-3),
    ((3, 4, 5, 6, 7), 10, 0.0),  # pushed past full: the ring has rolled
    ((0, 1), 6, 0.0),  # fewer than K frames: never a new keyframe
]


def test_counting_map_and_new_kf_bit_equal(cfgs, pan_frames):
    cfg, tcfg = cfgs
    frames, gt = pan_frames
    lvl = cfg.tracker.histogram_level
    k = cfg.tracker.n_frames_histogram_voting
    rng = np.random.default_rng(1)
    outcomes = set()
    for slots, cur, noise in VOTING_CASES:
        pj = jtracker.empty_past(k, cfg.pyramid.edge_capacity[lvl])
        for s in slots:
            cl = frames[s].levels[lvl].cloud
            pj = jtracker.push_past(pj, cl.points, cl.valid, jnp.asarray(gt[s]))
        xi = torch.from_numpy((rng.normal(size=6) * noise).astype(np.float32))
        est = (gt[cur] @ lie.matrix_from_rt(*lie.exp_se3(xi)).numpy()).astype(np.float32)
        pt = convert.past_from_numpy(_np_tree(pj))
        m_j = np.asarray(_jax_counting_map(pj, jnp.asarray(est), cfg))
        m_t = tracker.counting_map(pt, torch.from_numpy(est), tcfg).numpy()
        np.testing.assert_array_equal(m_t, m_j, err_msg=f"case {slots} -> {cur}")
        assert m_t.max() > 0
        nj = bool(jtracker.assess_tracking_quality(pj, jnp.asarray(est), frames[cur], cfg))
        nt = bool(tracker.assess_tracking_quality(
            pt, torch.from_numpy(est), convert.frame_from_numpy(_np_tree(frames[cur])), tcfg))
        assert nt == nj, f"case {slots} -> {cur}: new_kf {nt} != JAX {nj}"
        outcomes.add(nt)
    assert outcomes == {True, False}


# -- relocalization candidate choice --------------------------------------------

# (errors, good counts, active slots): slot 0 is the newest
SELECT_CASES = [
    ([0.5, 0.4, 0.4, 0.1, 0.1], [500] * 5, 3),  # tie -> newer slot; inactive never
    ([3.0, 0.9, 0.2, 0.1, 0.1], [500, 500, 50, 500, 500], 5),  # thresholds; tie 3/4
    ([3.0, 2.5, 0.3, 0.1, 0.1], [500] * 5, 2),  # nothing admissible
    ([0.7, 0.7, 0.7, 0.7, 0.7], [500] * 5, 1),  # one active slot
]


@pytest.mark.parametrize("case", range(len(SELECT_CASES)))
def test_select_reloc_candidate_matches_jax(cfgs, case):
    cfg, tcfg = cfgs
    errors, goods, n = SELECT_CASES[case]
    k = len(errors)
    rng = np.random.default_rng(case)
    fields = dict(
        R=np.stack([np.asarray(lie.exp_so3(torch.from_numpy(
            rng.normal(size=3).astype(np.float32)))) for _ in range(k)]),
        t=rng.normal(size=(k, 3)).astype(np.float32),
        error=np.asarray(errors, np.float32),
        good=np.asarray(goods, np.int32),
        bad=rng.integers(0, 100, k).astype(np.int32),
        new_kf=rng.random(k) < 0.5,
    )
    rj = jtracker.TrackResult(**{a: jnp.asarray(v) for a, v in fields.items()})
    rt = tracker.TrackResult(**{a: torch.from_numpy(v) for a, v in fields.items()})
    fj, ij, sj = jtracker.select_reloc_candidate(rj, jnp.int32(n), cfg)
    ft, it, st = tracker.select_reloc_candidate(rt, n, tcfg)
    assert (bool(ft), int(it)) == (bool(fj), int(ij))
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- VOSystem -------------------------------------------------------------------


@pytest.fixture(scope="module")
def pan_runs(cfgs, pan):
    """Both VOSystems over the pan: ((JAX poses, flags), (port poses, flags),
    JAX system, port system, port report).  test_teleport continues both."""
    cfg, tcfg = cfgs
    frames, _ = pan
    vj, vt = jsystem.VOSystem(cfg), system.VOSystem(tcfg, device="cpu")
    return run_host(vj, frames), run_host(vt, frames), vj, vt, vt.report()


def test_vosystem_pan_matches_jax(pan, pan_runs):
    (pj, fj), (pt, ft), _, vo, report = pan_runs
    np.testing.assert_array_equal(ft, fj)
    assert ft[1:, 0].sum() >= 2  # the pan promotes
    assert_poses_close(pt, pj)
    for node in vo.pose_graph[: len(pan[0])]:
        np.testing.assert_allclose(node.T_w_curr, node.T_w_kf @ node.T_kf_curr, atol=1e-6)
    assert report.frames_tracked == len(pan[0]) and report.keyframes >= 3


def teleport(vo, cam):
    """tests/test_relocalization.py:14-38: the next frame is rendered at
    frame 0's pose (the identity), with the motion prior poisoned."""
    g0, d0 = tsyn.render_frame(tsyn.SyntheticScene(), cam, np.eye(4, dtype=np.float32))
    vo.T_nm1_n = np.eye(4, dtype=np.float32)
    vo.T_nm1_n[:3, 3] = [1.5, 1.0, -0.8]
    R, t = vo.T_nm1_n[:3, :3].copy(), vo.T_nm1_n[:3, 3].copy()
    if isinstance(vo, system.VOSystem):
        vo.R, vo.t = torch.from_numpy(R), torch.from_numpy(t)
    else:
        vo.R, vo.t = jnp.asarray(R), jnp.asarray(t)
    return run_host(vo, [(g0, d0, 99.0)])


def test_teleport_relocalizes_like_jax(cfgs, pan_runs):
    """After the pan, a teleport back to frame 0's view: the jump gate
    fires and the ring search re-anchors on the first keyframe."""
    *_, vj, vt, _ = pan_runs
    pj, fj = teleport(vj, cfgs[0].camera)
    pt, ft = teleport(vt, cfgs[0].camera)
    np.testing.assert_array_equal(ft, fj)
    assert ft.tolist() == [[0, 1, 0]]
    assert (vt.n_relocalized, vt.n_tracking_lost) == (vj.n_relocalized, vj.n_tracking_lost)
    assert_poses_close(pt, pj)
    assert np.linalg.norm(pt[-1, :3, 3]) < 0.02


def test_lost_frame_coasts_like_jax(cfgs):
    """tests/test_relocalization.py:40-56: a frame with no structure and no
    depth is lost, fails relocalization and coasts on the motion prior."""
    cfg, tcfg = cfgs
    seq = list(tsyn.render_sequence(tsyn.SyntheticScene(), cfg.camera, 6, seed=12))
    flat = np.full((cfg.camera.height, cfg.camera.width), 128.0, np.float32)
    frames = [(g, d, ts) for g, d, _, ts in seq] + [(flat, np.zeros_like(flat), 99.0)]
    vj, vt = jsystem.VOSystem(cfg), system.VOSystem(tcfg, device="cpu")
    pj, fj = run_host(vj, frames)
    pt, ft = run_host(vt, frames)
    np.testing.assert_array_equal(ft, fj)
    assert vt.n_tracking_lost == vj.n_tracking_lost == 1
    assert_poses_close(pt, pj)
    assert np.linalg.norm(pt[-1, :3, 3] - pt[-2, :3, 3]) < 0.05


def test_unported_options_raise(cfgs):
    _, tcfg = cfgs
    lc = dataclasses.replace(tcfg, tracker=dataclasses.replace(tcfg.tracker,
                                                               online_loop_closure=True))
    with pytest.raises(NotImplementedError, match="P12"):
        system.VOSystem(lc, device="cpu")
    ud = dataclasses.replace(tcfg, pyramid=dataclasses.replace(tcfg.pyramid, undistort=True))
    with pytest.raises(NotImplementedError, match="P11"):
        system.VOSystem(ud, device="cpu")


def test_cuda_device_without_card_raises(cfgs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        system.VOSystem(cfgs[1], device="cuda")


def test_prune_keyframe_and_rgb_to_gray_match_jax(cfgs, pan_frames):
    cfg, _ = cfgs
    frames, gt = pan_frames
    full = jfront.make_keyframe(frames[0], jnp.eye(4), cfg)
    kj = jfront.prune_keyframe(full)
    kt = frontend.prune_keyframe(convert.keyframe_from_numpy(_np_tree(full)))
    for lj, lt in zip(kj.frame.levels, kt.frame.levels):
        for name in ("gray", "depth", "edges", "edges_orig"):
            assert tuple(getattr(lt, name).shape) == np.asarray(getattr(lj, name)).shape == (1, 1)
        np.testing.assert_array_equal(lt.cloud.points.numpy(), np.asarray(lj.cloud.points))
    np.testing.assert_array_equal(kt.quads[0].float().numpy(),
                                  np.asarray(kj.quads[0]).astype(np.float32))
    rgb = np.random.default_rng(3).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        frontend.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
        np.asarray(jfront.rgb_to_gray(jnp.asarray(rgb))),
    )
