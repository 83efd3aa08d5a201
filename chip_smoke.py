"""Smoke run of the PyTorch port on one CUDA card (the H100 it targets).

    python3 chip_smoke.py

Drives revo_tpu_torch's per-frame tracking step end to end at full width:
one 640x480 RGB-D sequence (8 frames, TUM fr1 intrinsics, 3 levels, default
SystemConfig), keyframe from frame 0, frames 1..7 tracked in a chain, with
solver "lm" and then "gn_fixed".  Phases, one line each:

1. device    the card, its power limit, TF32 pinned off;
2. build     nvcc build of revo_tpu_torch/csrc/*.cu (sm_90a);
3. frames    render the synthetic sequence (numpy, worker processes);
4. kernels   each CUDA kernel against its plain PyTorch version on the card,
             at main-path shapes: K1 + K2 bit-equal on the 3 pyramid levels
             of the 8 frames at B=1 and B=8; K3 on every level's residual
             inputs at identity and at the tracked pose, within 1e-5 of the
             largest entry of each output;
5. main      the main path on the card with launch counts reset just before
             it; every kernel must have launched, outputs finite, poses
             within 1e-4 m / 1e-4 rad of the same path on the CPU (plain
             versions), ATE against ground truth < 2 mm for both solvers;
6. times     CUDA-event times per stage and per kernel against its plain
             version at the level-0 shape.

Any failed phase raises and the exit code is nonzero.  The second-to-last
lines are the kernel JSON and the card's name and power limit; the last line
is the JSON result.  Without a CUDA device it exits nonzero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 8
ATE_LIMIT_M = 2e-3
POSE_TOL = 1e-4  # metres and radians, card against CPU
K3_RTOL = 1e-5  # of the largest entry of each output


def _phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call by CUDA events over ``reps`` calls, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _with_solver(cfg, solver):
    opt = dataclasses.replace(cfg.tracker.optimizer, solver=solver)
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt)
    )


def _run_chain(grays, depths, cfg, device):
    """build_frame -> make_keyframe -> track_frames over the sequence on
    ``device``; returns (frames, keyframe, est poses (N, 4, 4), results)."""
    import torch

    from revo_tpu_torch import frontend, tracker

    frames = [
        frontend.build_frame(
            torch.from_numpy(g).to(device), torch.from_numpy(d).to(device), cfg
        )
        for g, d in zip(grays, depths)
    ]
    kf = frontend.make_keyframe(frames[0], torch.eye(4, device=device), cfg)
    R, t = torch.eye(3, device=device), torch.zeros(3, device=device)
    est = [np.eye(4)]
    results = []
    for f in frames[1:]:
        res = tracker.track_frames(kf, f, R, t, cfg)
        R, t = res.R, res.t
        T = np.eye(4)
        T[:3, :3] = R.cpu().numpy()
        T[:3, 3] = t.cpu().numpy()
        est.append(T)
        results.append(res)
    return frames, kf, np.stack(est), results


def _rot_angle(Ra, Rb) -> float:
    """Angle of Ra^T Rb, by atan2 (acos loses precision near 0)."""
    D = Ra.T @ Rb
    s = math.hypot(D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]) / 2.0
    return math.atan2(s, (np.trace(D) - 1.0) / 2.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from revo_tpu_torch import kernels, solver
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.eval import absolute_trajectory_error
    from revo_tpu_torch.io.synthetic import SyntheticScene, render_trajectory_parallel
    from revo_tpu_torch.ops import canny as K12
    from revo_tpu_torch.ops import lgsx as K3
    from revo_tpu_torch.ops.filters import _reflect_pad

    dev = torch.device("cuda")
    # -- 1. device -----------------------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 could not be turned off")
    smi = _smi()
    _phase("device", kind=torch.cuda.get_device_name(0), smi=smi,
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda, cudnn_tf32=torch.backends.cudnn.allow_tf32,
           matmul_tf32=torch.backends.cuda.matmul.allow_tf32)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.library()
    _phase("build", seconds=round(time.perf_counter() - t0, 3),
           nvcc_seconds=round(lib.seconds, 3), built=lib.built,
           library=os.path.relpath(lib.path))

    # -- 3. frames -----------------------------------------------------------
    cfg = SystemConfig()
    cam = cfg.camera
    scene = SyntheticScene()
    t0 = time.perf_counter()
    traj = scene.trajectory(N_FRAMES, seed=0)
    rendered = render_trajectory_parallel(
        scene, cam, traj, seed=0, workers=min(N_FRAMES, max(os.cpu_count() - 1, 1))
    )
    grays = [g.astype(np.uint8) for g, _, _, _ in rendered]
    depths = [
        (d * cfg.dataset.depth_scale_factor).astype(np.uint16) for _, d, _, _ in rendered
    ]
    gt = np.stack([T for _, _, T, _ in rendered]).astype(np.float64)
    _phase("frames", n=N_FRAMES, shape=list(grays[0].shape),
           seconds=round(time.perf_counter() - t0, 3))

    # -- 5. main path (run before phase 4, which needs its frames) ----------
    counters = (K12.canny_nms, K12.canny_hysteresis, K3.lgsx_reduce)
    for c in counters:
        c.launches = 0
    gpu = {}
    for name in ("lm", "gn_fixed"):
        gpu[name] = _run_chain(grays, depths, _with_solver(cfg, name), dev)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")

    summary = {"launches": launches}
    for name in ("lm", "gn_fixed"):
        frames, kf, est, results = gpu[name]
        for r in results:
            vals = torch.cat([r.R.reshape(-1), r.t, r.error.reshape(1)])
            if not bool(torch.isfinite(vals).all()):
                raise RuntimeError(f"{name}: non-finite tracking output")
        for s in kf.structs:
            if not bool(torch.isfinite(s).all()):
                raise RuntimeError("non-finite keyframe structure")
        _, _, est_cpu, _ = _run_chain(grays, depths, _with_solver(cfg, name), "cpu")
        dt = float(np.abs(est[:, :3, 3] - est_cpu[:, :3, 3]).max())
        dr = max(_rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(est, est_cpu))
        ate = absolute_trajectory_error(est, gt).rmse
        # The JAX bench's ATE (bench.py _ate_m): RMSE without alignment.
        rmse = float(np.sqrt(np.mean(np.sum((est[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1))))
        summary[name] = {"ate_m": ate, "rmse_unaligned_m": rmse,
                         "vs_cpu_m": dt, "vs_cpu_rad": dr,
                         "final_error": float(results[-1].error)}
        if not (dt <= POSE_TOL and dr <= POSE_TOL):
            raise RuntimeError(f"{name}: card poses differ from CPU by {dt} m, {dr} rad")
        if not ate < ATE_LIMIT_M:
            raise RuntimeError(f"{name}: ATE {ate} m >= {ATE_LIMIT_M} m")

    # -- 4. kernels against their plain versions on the card ----------------
    frames_lm, kf_lm, _, results_lm = gpu["lm"]
    pyr = cfg.pyramid
    lo = min(pyr.canny_threshold1, pyr.canny_threshold2) ** 2
    hi = max(pyr.canny_threshold1, pyr.canny_threshold2) ** 2
    k12_diff = 0  # differing mask pixels; any one fails the phase
    for lvl in range(cfg.pyramid.n_levels):
        g = torch.stack([f.levels[lvl].gray for f in frames_lm])  # (8, H, W)
        for batch in [g[i:i + 1] for i in range(len(frames_lm))] + [g]:
            gp = _reflect_pad(batch, 1, 1).contiguous()
            c_k, s_k = K12.canny_nms(gp, lo, hi)
            c_p, s_p = K12.canny_nms_ref(gp, lo, hi)
            r_k = K12.canny_hysteresis(c_p, s_p)
            r_p = K12.hysteresis_ref(c_p, s_p)
            n_diff = int((c_k != c_p).sum() + (s_k != s_p).sum())
            h_diff = int((r_k != r_p).sum())
            if n_diff or h_diff:
                raise RuntimeError(
                    f"K1/K2 differ from plain at level {lvl} B={batch.shape[0]}: "
                    f"{n_diff} NMS, {h_diff} hysteresis pixels"
                )
            k12_diff = max(k12_diff, n_diff, h_diff)
    k12_err = float(min(k12_diff, 1))  # max |kernel - plain| of 0/1 masks
    opt = cfg.tracker.optimizer
    cams = cfg.camera_pyramid()
    k3_err, k3_rel = 0.0, 0.0
    poses = [(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
             (results_lm[-1].R, results_lm[-1].t)]
    for lvl in range(cfg.pyramid.n_levels):
        for R, t in poses:
            terms = solver.residual_terms(
                kf_lm.quads[lvl], frames_lm[-1].levels[lvl].cloud, cams[lvl], R, t,
                opt.edge_distance_lvl[lvl], opt.huber_edge, opt.use_edge_filter,
            )
            got = K3.lgsx_reduce(*terms[:4])
            want = K3.lgsx_reduce_ref(*terms[:4])
            for a, b in zip(got, want):
                err = float((a - b).abs().max())
                rel = err / max(float(b.abs().max()), 1e-30)
                k3_err, k3_rel = max(k3_err, err), max(k3_rel, rel)
    if not k3_rel <= K3_RTOL:
        raise RuntimeError(f"K3 differs from plain by {k3_rel} (relative) > {K3_RTOL}")
    _phase("kernels", k1_k2_differing_pixels=k12_diff, k3_max_abs_err=k3_err,
           k3_max_rel_err=k3_rel, k3_rtol=K3_RTOL)
    _phase("main", **summary)

    # -- 6. times ------------------------------------------------------------
    cfg_lm = _with_solver(cfg, "lm")
    from revo_tpu_torch import frontend, tracker

    g0 = torch.from_numpy(grays[1]).to(dev)
    d0 = torch.from_numpy(depths[1]).to(dev)
    f1 = frames_lm[1]
    stage_ms = {
        "build_frame": _time_ms(lambda: frontend.build_frame(g0, d0, cfg_lm), 10),
        "make_keyframe": _time_ms(
            lambda: frontend.make_keyframe(f1, torch.eye(4, device=dev), cfg_lm), 5
        ),
    }
    for name in ("lm", "gn_fixed"):
        c = _with_solver(cfg, name)
        frames, kf, _, _ = gpu[name]

        def chain():
            R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
            for f in frames[1:]:
                res = tracker.track_frames(kf, f, R, t, c)
                R, t = res.R, res.t

        stage_ms[f"track_frames_{name}"] = _time_ms(chain, 3, warmup=1) / (N_FRAMES - 1)

    gp0 = _reflect_pad(frames_lm[1].levels[0].gray[None], 1, 1).contiguous()
    c0, s0 = K12.canny_nms_ref(gp0, lo, hi)
    terms0 = solver.residual_terms(
        kf_lm.quads[0], frames_lm[-1].levels[0].cloud, cams[0],
        results_lm[-1].R, results_lm[-1].t,
        opt.edge_distance_lvl[0], opt.huber_edge, opt.use_edge_filter,
    )[:4]
    kern = [
        ("canny_nms", "canny.cu", "revo_tpu/ops/pallas/canny_kernel.py:127",
         lambda: K12.canny_nms(gp0, lo, hi),
         lambda: K12.canny_nms_ref(gp0, lo, hi), k12_err),
        ("canny_hysteresis", "canny.cu", "revo_tpu/ops/pallas/hysteresis.py:102",
         lambda: K12.canny_hysteresis(c0, s0),
         lambda: K12.hysteresis_ref(c0, s0), k12_err),
        ("lgsx_reduce", "lgsx.cu", "revo_tpu/ops/pallas/lgsx.py:103",
         lambda: K3.lgsx_reduce(*terms0),
         lambda: K3.lgsx_reduce_ref(*terms0), k3_err),
    ]
    rows = []
    for name, src, replaces, fk, fp, err in kern:
        ms_k, ms_p = _time_ms(fk, 50), _time_ms(fp, 50)
        ms_k2, ms_p2 = _time_ms(fk, 50), _time_ms(fp, 50)
        rows.append({
            "name": name, "route": "cuda", "source": f"revo_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": min(ms_k, ms_k2), "plain_ms": min(ms_p, ms_p2),
        })
    _phase("times", smi=smi, stage_ms_per_frame=stage_ms,
           kernel_ms={r["name"]: [r["ms"], r["plain_ms"]] for r in rows})

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
