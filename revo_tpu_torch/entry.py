"""Entry points (counterpart of ``__graft_entry__`` at the repo root).

- ``entry()`` returns the full 640x480 frame-to-keyframe tracking step of
  the flagship configuration and example arguments for it: a keyframe built
  from one synthetic frame and a second frame rendered after a small motion.
- ``dryrun_multichip(n)`` runs every mesh form of the port once on n slots
  (``parallel.mesh``): sequences, points, segments, the two-stage pipeline,
  the full-system scan, candidate verification, windowed BA and the pose
  graph, each with the JAX dry run's own checks, and prints its summary
  line.  By default the slots go round-robin over the CUDA devices (n = 8
  on one card: eight slots of cuda:0); it raises without a card unless the
  caller names the devices, e.g. ``[torch.device("cpu")] * n``.

    python -m revo_tpu_torch.entry [N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from revo_tpu_torch import lie, solver, tracker
from revo_tpu_torch.config import CameraConfig, SystemConfig
from revo_tpu_torch.frontend import (
    build_frame, build_frame_batched, make_keyframe, make_keyframe_batched,
)
from revo_tpu_torch.io.synthetic import (
    SyntheticScene, _exp_so3_host, _libm_sincos, render_frame, render_trajectory,
)
from revo_tpu_torch.kernels import check_device
from revo_tpu_torch.loopclosure import find_candidates, verify_candidates_batched
from revo_tpu_torch.ops.project import sqrt_rn
from revo_tpu_torch.parallel import batch, mesh as pmesh, pipeline, posegraph, segments
from revo_tpu_torch.parallel.windowed import (
    Window, make_pairs, optimize_window, optimize_window_sharded,
)


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


# -- the multi-device dry run ---------------------------------------------------

# The scan's pan directions, k * 2 pi / 16 for these k: each fires a
# promotion and its teleport relocalizes to under 2 cm.  The basins of the
# synthetic texture part at ~1e-4 changes of the trajectory, so the exact
# phases are pinned (__graft_entry__.py:212-220).
PAN_PHASES = [k * 2.0 * np.pi / 16.0 for k in (0, 2, 6, 7, 8, 10, 11, 12, 15)]
N_PAN = 24  # pan frames of each scan sequence; two teleport frames follow
SCAN_TOL = 1e-5  # sharded scan against each sequence's vo_scan
TELEPORT_TOL_M = 0.02
LOOP_TOL = 1e-5  # sharded verification poses against the mesh-less call
BA_TOL = 2e-4  # pair-sharded window against optimize_window
N_WINDOW, WINDOW_ITERS, WINDOW_SIGMA = 6, 6, 0.006


def _dryrun_cfg() -> SystemConfig:
    """64x48, 3 levels, small clouds: the sequence, point, segment and
    pipeline parts."""
    cam = CameraConfig(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)
    return SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(512, 256, 128), dist_patch_sizes=(8, 4, 2)))


def _dryrun_scan_cfg() -> SystemConfig:
    """160x120 with scan relocalization, a 0.1 m jump gate and a ring of 4:
    the scan, verification and windowed BA parts."""
    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg = SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024), dist_patch_sizes=(20, 10, 5)))
    return dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, scan_relocalization=True, max_jump_translation=0.1, kf_history_size=4))


def _fma_f32(a: float, b: float, c: float) -> np.float32:
    """a * b + c of float32 operands as a fused multiply-add: the product is
    exact in float64, the sum rounded there and then to float32 (a double
    rounding differs from one only on ties the dry run's inputs do not
    hit; tests/test_torch_dryrun.py holds them bit-equal)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _exp_se3_host(xi: np.ndarray) -> np.ndarray:
    """The 4x4 matrix of ``lie.exp_se3`` of one float32 6-vector as the JAX
    package computes it eagerly on the CPU: sine and cosine from the C
    library, V @ upsilon as one FMA chain a row (XLA's CPU dot), the rest
    ``lie``'s float32 arithmetic.  The dry run's motions and perturbations
    are made with it, so its frames and poses are the JAX dry run's bits."""
    xi = np.asarray(xi, np.float32)
    omega, upsilon = torch.from_numpy(xi[3:].copy()), xi[:3]
    sinf, cosf = _libm_sincos()
    theta_sq = torch.sum(omega * omega)
    if float(theta_sq) < lie._EPS:
        b, c = 0.5 - theta_sq / 24.0, 1.0 / 6.0 - theta_sq / 120.0
    else:
        theta = sqrt_rn(theta_sq)
        b = (1.0 - torch.tensor(cosf(float(theta)))) / (theta * theta)
        c = (theta - torch.tensor(sinf(float(theta)))) / (theta * theta * theta)
    W = lie.hat_so3(omega)
    V = (torch.eye(3) + b * W + c * (W @ W)).numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _exp_so3_host(omega).numpy()
    for i in range(3):
        acc = np.float32(V[i, 0] * upsilon[0])
        for k in (1, 2):
            acc = _fma_f32(V[i, k], upsilon[k], acc)
        T[i, 3] = acc
    return T


def _pan_traj(n: int, step: float, phase: float) -> np.ndarray:
    """(n, 4, 4) float32: a straight pan along a phase-dependent direction
    with a growing yaw and pitch (__graft_entry__.py:222-234, bit for bit)."""
    d = np.array([np.cos(phase), 0.55 * np.sin(phase), 0.3])
    d /= np.linalg.norm(d)
    poses = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        omega = np.array([0.004 * i * np.sin(phase), 0.012 * i * np.cos(phase), 0], np.float32)
        T[:3, :3] = _exp_so3_host(torch.from_numpy(omega)).numpy()
        T[:3, 3] = step * i * d
        poses.append(T)
    return np.stack(poses)


def _dryrun_inputs(n: int) -> dict:
    """Every array the dry run feeds its parts, rendered on the host from
    seeds (numpy): the n frame pairs (64x48), the n scan sequences (160x120,
    24 pan frames and two teleports back to the start) with their pan
    trajectories, the out-and-back loop keyframes' poses and frames, the
    window's perturbed poses and the pose graph's trajectory."""
    cfg, cfg_s = _dryrun_cfg(), _dryrun_scan_cfg()
    scene = SyntheticScene()
    pairs = []
    for i in range(n):
        T1 = _exp_se3_host([0.004 * (i % 3), -0.003, 0.004, 0.002, 0.0, -0.001])
        pairs.append(render_frame(scene, cfg.camera, np.eye(4, dtype=np.float32), seed=i)
                     + render_frame(scene, cfg.camera, T1, seed=i))
    grays0, depths0, grays1, depths1 = (np.stack(x) for x in zip(*pairs))

    scan_g, scan_d, trajs = [], [], []
    for i in range(n):
        traj = _pan_traj(N_PAN, 0.03, PAN_PHASES[i % len(PAN_PHASES)])
        frames = list(render_trajectory(scene, cfg_s.camera, traj, seed=i))
        g0, d0 = render_frame(scene, cfg_s.camera, traj[0], seed=i * 1000)
        scan_g.append(np.stack([f[0] for f in frames] + [g0, g0]))
        scan_d.append(np.stack([f[1] for f in frames] + [d0, d0]))
        trajs.append(traj)

    loop_traj = _pan_traj(8, 0.035, 0.785)
    loop_traj = np.concatenate([loop_traj[:5], loop_traj[[3, 2, 1, 0]]])  # out and back
    loop_frames = [render_frame(scene, cfg_s.camera, T, seed=k) for k, T in enumerate(loop_traj)]

    rng = np.random.default_rng(3)
    window_poses = []
    for k, T in enumerate(loop_traj[:N_WINDOW]):
        xi = rng.normal(size=6).astype(np.float32) * WINDOW_SIGMA
        window_poses.append(_exp_se3_host(xi) @ T if k > 0 else T)

    n_pg = 2 * n  # edges divide by the slots
    graph = np.tile(np.eye(4, dtype=np.float32), (n_pg + 1, 1, 1))
    graph[:, 0, 3] = np.linspace(0, 0.1, n_pg + 1).astype(np.float32)
    return {
        "grays0": grays0, "depths0": depths0, "grays1": grays1, "depths1": depths1,
        "scan_grays": np.stack(scan_g), "scan_depths": np.stack(scan_d),
        "scan_trajs": np.stack(trajs), "loop_traj": loop_traj,
        "loop_grays": np.stack([f[0] for f in loop_frames]),
        "loop_depths": np.stack([f[1] for f in loop_frames]),
        "window_poses": np.stack(window_poses).astype(np.float32), "graph_poses": graph,
    }


def _slots(n: int, devices=None) -> list:
    if devices is None:
        cards = pmesh.cuda_devices()
        return [cards[i % len(cards)] for i in range(n)]
    devices = [check_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices given for {n} slots")
    return devices


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run every mesh form once on ``n_devices`` slots and check each as the
    JAX dry run does (__graft_entry__.dryrun_multichip); print its summary
    line and return its numbers: ``mean_t``, ``scan_max_dev``,
    ``promotions``, ``relocs``, ``n_loops``, ``ba_dev``, ``frames``,
    ``slots``, the ``seconds`` each part took and under ``parts`` each
    part's outputs on the host (the tests hold them to the JAX package's).

    ``devices`` names the n slots' devices (default: round-robin over the
    CUDA devices, raising without one).  The inputs are
    ``_dryrun_inputs(n_devices)``, rendered on the host.  Slots run one
    after the other, never from threads (``parallel.mesh``)."""
    n = n_devices
    slots = _slots(n, devices)
    home = slots[0]
    x = _dryrun_inputs(n)
    cfg, cfg_s = _dryrun_cfg(), _dryrun_scan_cfg()

    def mesh(axis):
        return pmesh.make_mesh((axis,), devices=slots)

    def on(a, device=home):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    seconds = {}
    t0 = time.perf_counter()

    # dp: one frame pair a slot over "seq": build both, keyframe, track.
    mesh_seq = mesh("seq")
    outs = []
    for g0, d0, g1, d1 in zip(*(pmesh.shard(torch.from_numpy(x[k]), mesh_seq, "seq")
                                for k in ("grays0", "depths0", "grays1", "depths1"))):
        b, dev = g0.shape[0], g0.device
        kf = make_keyframe_batched(build_frame_batched(g0, d0, cfg),
                                   torch.eye(4, device=dev).repeat(b, 1, 1), cfg)
        res = tracker.track_frames_batched(
            kf, build_frame_batched(g1, d1, cfg), torch.eye(3, device=dev).repeat(b, 1, 1),
            torch.zeros(b, 3, device=dev), cfg)
        outs.append((res.R, res.t, res.error))
    R, t, err = (_host(pmesh.gather(list(parts), mesh_seq, "seq")) for parts in zip(*outs))
    assert R.shape == (n, 3, 3)
    assert np.isfinite(err).all(), "non-finite tracking error"
    seconds["dp"] = time.perf_counter() - t0

    # tp: level 0 of pair 0, its points sharded over "pt"; the keyframe's
    # structure sampled as (H*W, 3) rows, as JAX samples it.
    t0 = time.perf_counter()
    f0s = build_frame(on(x["grays0"][0]), on(x["depths0"][0]), cfg)
    f1s = build_frame(on(x["grays1"][0]), on(x["depths1"][0]), cfg)
    kfs = make_keyframe(f0s, torch.eye(4, device=home), cfg)
    opt = cfg.tracker.optimizer
    sys_tp = solver.residual_system_point_sharded(
        kfs.structs[0].flatten(0, 1), f1s.levels[0].cloud, cfg.camera_pyramid()[0],
        torch.eye(3, device=home), torch.zeros(3, device=home), opt.edge_distance_lvl[0],
        opt.huber_edge, opt.use_edge_filter, mesh("pt"))
    assert np.isfinite(float(sys_tp.err)), "TP point-sharded system"
    seconds["tp"] = time.perf_counter() - t0

    # sp: 2n + 1 frames in n segments over "seq", stitched.
    t0 = time.perf_counter()
    n_seg_frames = 2 * n + 1  # (N - 1) % n_segments == 0
    idx = [i % n for i in range(n_seg_frames)]
    sp_poses = segments.track_long_sequence(on(x["grays0"][idx]), on(x["depths0"][idx]), cfg,
                                            n_segments=n, mesh=mesh_seq)
    assert np.isfinite(_host(sp_poses)).all(), "SP segment stitch"
    seconds["sp"] = time.perf_counter() - t0

    # pp: build on slot 0, solve on slot 1 (two streams of one card).
    t0 = time.perf_counter()
    pp_poses, _ = pipeline.pipeline_replay(
        [x["grays0"][0], x["grays1"][0]], [x["depths0"][0], x["depths1"][0]], cfg,
        devices=slots[:2])
    assert np.isfinite(_host(pp_poses)).all(), "PP pipeline replay"
    seconds["pp"] = time.perf_counter() - t0

    # The full-system scan, one sequence a slot: each must equal its own
    # vo_scan, promote, relocalize, and come back from the teleport.
    t0 = time.perf_counter()
    gseq, dseq, trajs = x["scan_grays"], x["scan_depths"], x["scan_trajs"]
    sp = _host(batch.vo_scan_batched(on(gseq), on(dseq), cfg_s, mesh=mesh_seq))
    assert np.isfinite(sp).all(), "scan shard_map"
    seconds["scan_sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    max_dev, n_prom, n_reloc, flags = 0.0, [], [], []
    for i in range(n):
        ref_poses, scan_outs, _ = batch.vo_scan(on(gseq[i], slots[i]), on(dseq[i], slots[i]), cfg_s)
        max_dev = max(max_dev, float(np.abs(sp[i] - _host(ref_poses)).max()))
        prom, rel = _host(scan_outs.promoted), _host(scan_outs.relocalized)
        assert prom.any(), f"device {i}: no keyframe promotion fired"
        assert rel.any(), f"device {i}: no relocalization fired"
        tele_err = float(np.linalg.norm(sp[i, N_PAN, :3, 3] - trajs[i][0][:3, 3]))
        assert tele_err < TELEPORT_TOL_M, f"device {i}: teleport err {tele_err:.3f} m"
        n_prom.append(int(prom.sum()))
        n_reloc.append(int(rel.sum()))
        flags.append(np.stack([prom, rel, _host(scan_outs.lost)], axis=-1))
    assert max_dev < SCAN_TOL, f"sharded vo_scan diverges from single-process: {max_dev}"
    seconds["scan_single"] = time.perf_counter() - t0

    # Loop verification: the out-and-back keyframes' candidates over "cand"
    # against the mesh-less call.
    t0 = time.perf_counter()
    kfs_lc = [make_keyframe(build_frame(on(g), on(d), cfg_s), on(T), cfg_s)
              for g, d, T in zip(x["loop_grays"], x["loop_depths"], x["loop_traj"])]
    cands = find_candidates([_host(k.T_w_k) for k in kfs_lc], min_separation=2, radius=0.08)
    assert cands, "no loop candidates on the revisit trajectory"
    ver_sh = verify_candidates_batched(kfs_lc, cands, cfg_s, mesh=mesh("cand"), axis="cand")
    ver_1 = verify_candidates_batched(kfs_lc, cands, cfg_s)
    n_loops = sum(1 for v in ver_sh if v is not None)
    assert n_loops >= 1, "no loop candidate verified under the mesh"
    for a, b in zip(ver_sh, ver_1):
        assert (a is None) == (b is None), "sharded verify decision differs"
        if a is not None:
            assert float(np.abs(a[0] - b[0]).max()) < LOOP_TOL, (
                "sharded loop verify pose differs from single-device")
    seconds["loop_verify"] = time.perf_counter() - t0

    # Windowed BA: the first six loop keyframes from perturbed poses, the
    # pairs sharded over "pair", against the unsharded joint LM.
    t0 = time.perf_counter()
    win = Window(
        structs=torch.stack([k.structs[0] for k in kfs_lc[:N_WINDOW]]),
        points=torch.stack([k.frame.levels[0].cloud.points for k in kfs_lc[:N_WINDOW]]),
        valid=torch.stack([k.frame.levels[0].cloud.valid for k in kfs_lc[:N_WINDOW]]),
        poses=on(x["window_poses"]),
    )
    opt_w, cam0 = cfg_s.tracker.optimizer, cfg_s.camera_pyramid()[0]
    poses_sh = _host(optimize_window_sharded(win, cam0, opt_w, mesh("pair"), iters=WINDOW_ITERS,
                                             radius=2))
    poses_1w, _ = optimize_window(win, *make_pairs(N_WINDOW, radius=2, device=home), cam0, opt_w,
                                  iters=WINDOW_ITERS)
    ba_dev = float(np.abs(poses_sh - _host(poses_1w)).max())
    assert ba_dev < BA_TOL, f"pair-sharded windowed BA deviates {ba_dev:.2e}"
    assert np.isfinite(poses_sh).all()
    seconds["windowed_ba"] = time.perf_counter() - t0

    # Pose graph: 2n odometry edges sharded over "edge", two GN steps.
    t0 = time.perf_counter()
    pg = on(x["graph_poses"])
    pg_out = posegraph.optimize_pose_graph_sharded(pg, posegraph.trajectory_to_edges(pg),
                                                   mesh("edge"), iters=2)
    assert np.isfinite(_host(pg_out)).all(), "sharded pose-graph BA"
    seconds["pose_graph"] = time.perf_counter() - t0

    frames = int(gseq.shape[1])
    mean_t = float(np.linalg.norm(t, axis=-1).mean())
    print(
        f"[dryrun_multichip] {n} devices OK "
        f"(dp + tp-points + sp-segments + pp-pipeline + full-system scan + "
        f"sharded loop-closure verify + pair-sharded windowed BA + "
        f"edge-sharded pose-graph BA); "
        f"mean |t| = {mean_t:.4f} m; "
        f"scan parity OK on {n} sequences x {frames} frames "
        f"(max pose dev {max_dev:.2e}); "
        f"per-device promotions: {n_prom}; per-device relocs: {n_reloc}; "
        f"loop edges verified under mesh: {n_loops} (parity OK); "
        f"windowed-BA pair-sharded max dev: {ba_dev:.2e}; "
        f"per-device frames: {[frames] * n}",
        flush=True,
    )
    parts = {
        "dp": (R, t, err),
        "tp": {"good": int(sys_tp.info.good), "bad": int(sys_tp.info.bad), "A": _host(sys_tp.A),
               "g": _host(sys_tp.g), "err": float(sys_tp.err)},
        "sp": _host(sp_poses), "pp": _host(pp_poses), "scan": sp, "scan_flags": np.stack(flags),
        "candidates": cands, "verdicts": ver_sh, "window": poses_sh, "graph": _host(pg_out),
    }
    return {"mean_t": mean_t, "scan_max_dev": max_dev, "promotions": n_prom,
            "relocs": n_reloc, "n_loops": n_loops, "ba_dev": ba_dev, "frames": [frames] * n,
            "slots": [str(d) for d in slots], "seconds": seconds, "parts": parts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run every mesh form of the port once on N "
                                             "slots and print the dry run's summary line.")
    ap.add_argument("n", nargs="?", type=int, default=8, help="slots (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: round-robin over the cards (raises without one); cpu: "
                         "N slots of the CPU")
    args = ap.parse_args(argv)
    devices = None if args.device == "cuda" else [torch.device("cpu")] * args.n
    dryrun_multichip(args.n, devices=devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
