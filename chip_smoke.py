"""Smoke run of the PyTorch port on one CUDA card (the H100 it targets).

    python3 chip_smoke.py

Drives revo_tpu_torch end to end at full width (640x480, TUM fr1
intrinsics, 3 levels, default SystemConfig): the per-frame tracking step on
an 8-frame chain (keyframe from frame 0, frames 1..7 tracked, solver "lm"
and then "gn_fixed"), then the VO system loop: VOSystem.run, vo_scan and
capacity calibration on a fast 20-frame pan (4 cm + ~1 deg per frame, so
histogram voting promotes keyframes) followed by one teleport frame back at
frame 0's pose with the motion prior poisoned (so the jump gate fires and
the keyframe ring relocalizes).  Phases, one line each:

1. device    the card, its power limit, TF32 pinned off;
2. build     nvcc build of revo_tpu_torch/csrc/*.cu (sm_90a);
3. frames    render the synthetic sequence (numpy, worker processes);
4. kernels   each CUDA kernel against its plain PyTorch version on the card,
             at main-path shapes: K1 + K2 bit-equal on the 3 pyramid levels
             of the 8 frames at B=1 and B=8, K2 in both its forms (bit-packed
             in shared memory, the one these shapes take, and byte masks in
             global memory), also on a serpentine where the H+W cap binds and
             at a width that is no multiple of 32; K3 on every level's
             residual inputs at identity and at the tracked pose, within 1e-5
             of the largest entry of each output; fused K3 (residual_lgsx,
             what the solver launches) on 3 levels x {identity, tracked, a
             pose that throws most points out of the image} x {dt4bf, dt4}:
             good and bad counts equal, floats within 1e-5 of the largest
             entry, a second launch bit-identical, and no host sync;
5. main      the main path on the card with launch counts reset just before
             it; every kernel must have launched, outputs finite, poses
             within 1e-4 m / 1e-4 rad of the same path on the CPU (plain
             versions), ATE against ground truth < 2 mm for both solvers;
6. times     CUDA-event times per stage and per kernel against its plain
             version at the level-0 shape, beside the kernel's bound (bytes
             over 3.35 TB/s or operations over 67 TFLOP/s, whichever is
             larger), its device time alone (launches queued behind a spin
             kernel, CUDA events) and the launch floor (K1 on a 16x16
             image), the kernels torch launches per evaluation and per
             tracked frame (torch.profiler) beside the hand-written
             kernels' launch counts, and ms per frame of VOSystem and
             vo_scan;
7. vo        VOSystem.run on the card over pan + teleport: at least one
             promotion and one relocalization, never lost; per-frame flags
             equal to the same run on the CPU (plain versions), poses within
             1e-4 m / 1e-4 rad of it; ATE under 1.5x the JAX package's CPU
             ATE on this sequence; the TUM file run() writes reads back to
             the same poses;
8. scan      vo_scan on the card over the pan: promotion flags equal to
             phase 7's, poses within 5e-4 of them; vo_scan_batched at B=2
             (the pan and a second seed) equal lane by lane to vo_scan;
9. autotune  calibrate_capacities at margin 0.65 on the first 2 frames, on
             the card and on the CPU: equal capacities.

Phases print in the order 1, 2, 3, 4, 5, 7, 8, 9, 6.  Launch counts are set
to 0 just before each main path (phases 5, 7, 8, 9)
and read just after; every kernel of the path must have launched (K1, K2
and the fused K3; the unfused K3 ``lgsx_reduce`` is the TPU kernel's own
contract, which the solver no longer calls, so its count there is 0 and
the kernel JSON lists it under ``kernels_off_path``).  The kernel JSON's
``launches`` sum those four runs.  Any failed phase raises
and the exit code is nonzero.  The second-to-last
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
import tempfile
import time

import numpy as np

N_FRAMES = 8
ATE_LIMIT_M = 2e-3
POSE_TOL = 1e-4  # metres and radians, card against CPU
K3_RTOL = 1e-5  # of the largest entry of each output
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same sheet
# Operations per element, counted from the plain versions: K1 Sobel (2 x 11),
# magnitude (3), sector tests (6), NMS and thresholds (6); K2 per dilation
# step and word of 32 one-bit pixels (the function is bitwise, so a 32-bit
# operation serves 32 pixels) 8 neighbour ORs, AND, OR, compare, held to the
# float32 rate for want of a separate integer one; K3 per point Jacobian
# (36) and 28 multiply-adds with their weights (68); the fused form adds
# the projection (26), sampling (30) and weighting (6).
K1_OPS_PER_PIXEL, K2_OPS_PER_WORD_STEP = 37, 11
K3_OPS_PER_POINT, K3_FUSED_OPS_PER_POINT = 104, 166
GATHER_SECTOR_BYTES = 32  # one quad row costs one 32-byte sector
N_PAN = 20  # pan frames; the teleport frame follows
PAN_STEP = (0.04, 0.0, 0.005, 0.0, 0.017, 0.0)  # tests/test_system.py:47-73
# The JAX package's ATE on pan + teleport, VOSystem on the CPU (PERF.md
# section 2), times 1.5.
JAX_CPU_ATE_M = 0.001134469790991418
VO_ATE_LIMIT_M = 1.5 * JAX_CPU_ATE_M
# TUM file read back against the run: translations have 9 decimals; the
# rotation goes through a float32 quaternion, which also drops the pose
# products' drift from orthonormal (~2e-6 rad on a 160x120 rehearsal).
TUM_TOL_M, TUM_TOL_RAD = 1e-6, 1e-5
SCAN_TOL = 5e-4  # vo_scan against VOSystem (tests/test_batch.py:35-48)
CAPACITY_MARGIN = 0.65  # the JAX bench's operating point


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


def _max_pose_diff(a, b):
    """(max translation difference m, max rotation angle rad) of two
    (N, 4, 4) pose stacks."""
    dt = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    return dt, max(_rot_angle(x[:3, :3], y[:3, :3]) for x, y in zip(a, b))


def pan_sequence(n: int):
    """World poses of tests/test_system.py's fast lateral pan (n frames from
    the identity), then the teleport frame at frame 0's pose: (n + 1, 4, 4)."""
    import torch

    from revo_tpu_torch import lie

    step = lie.matrix_from_rt(*lie.exp_se3(torch.tensor(PAN_STEP))).numpy()
    T = np.eye(4, dtype=np.float32)
    traj = []
    for _ in range(n):
        traj.append(T.copy())
        T = T @ step
    return np.stack(traj + [traj[0]])


def poison_motion_prior(vo, to_tensor) -> None:
    """tests/test_relocalization.py:24-31: a stale constant-velocity prior
    that sends plain tracking of the teleport frame astray."""
    vo.T_nm1_n = np.eye(4, dtype=np.float32)
    vo.T_nm1_n[:3, 3] = [1.5, 1.0, -0.8]
    vo.R = to_tensor(vo.T_nm1_n[:3, :3].copy())
    vo.t = to_tensor(vo.T_nm1_n[:3, 3].copy())


def counters(vo) -> np.ndarray:
    return np.array([vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost])


def run_teleport(vo, grays, depths, pose_file, to_tensor):
    """vo.run over the pan with the motion prior poisoned just before the
    last (teleport) frame.  Returns (poses, per-frame (promoted,
    relocalized, lost) counter increments (N, 3), report)."""
    marks = []

    def frames():
        for i, (g, d) in enumerate(zip(grays, depths)):
            if i == len(grays) - 1:
                poison_motion_prior(vo, to_tensor)
            marks.append(counters(vo))
            yield g, d, i / 30.0

    poses, _, report = vo.run(frames(), pose_file=pose_file)
    marks.append(counters(vo))
    return poses, np.diff(np.stack(marks), axis=0), report


def _sensor_frames(rendered, cfg):
    """Rendered frames as a TUM sensor delivers them: uint8 gray and uint16
    depth scaled by DEPTH_SCALE_FACTOR."""
    grays = [g.astype(np.uint8) for g, _, _, _ in rendered]
    depths = [
        (d * cfg.dataset.depth_scale_factor).astype(np.uint16) for _, d, _, _ in rendered
    ]
    return grays, depths, np.stack([T for _, _, T, _ in rendered]).astype(np.float64)


def _path_launches(counters_, fn):
    """Run one main path with every launch count set to 0 just before it;
    returns (its result, the counts just after)."""
    import torch

    for c in counters_:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters_}


def _require_launched(phase, launches, names):
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise RuntimeError(f"{phase}: kernels of the path never launched: {missing} ({launches})")


def _bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the card's memory rate
    and operations over its float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def serpentine(h: int, w: int):
    """A 1-px snake longer than H+W from one seed (tests/test_torch_kernels.py):
    the fixpoint's cap binds before the snake is covered."""
    cand = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        cand[y, 1:w - 1] = True
        if y + 1 < h:
            cand[y + 1, (w - 2) if (y // 2) % 2 == 0 else 1] = True
    strong = np.zeros_like(cand)
    strong[0, 1] = True
    return cand[None], strong[None]


# Device functions of csrc/*.cu as the profiler names them.  The profiler
# shows launches made through ctypes only now and then, so it counts the
# kernels torch launches and the wrappers' launch counts count these.
HAND_KERNELS = ("canny_nms_kernel", "canny_hysteresis", "lgsx_reduce_kernel",
                "residual_lgsx_kernel")
HOLD_CYCLES = 60_000_000  # spin that holds the stream ~30 ms while launches queue


def _profile_kernels(fn, reps: int = 1):
    """(device kernels torch launches per call of ``fn``, their summed
    device ms per call, hand-written kernels the profiler showed per call),
    by torch.profiler; (-1, None, None) where the reading cannot be trusted.
    One profiler window holds 0.1 s of warm-up calls (the profiler drops the
    kernels of a window's first milliseconds) and two marked stretches of
    ``reps`` and ``2 * reps`` calls, each closed by one marker kernel and a
    synchronize,
    so a kernel belongs to the stretch whose host span holds its start.
    The reading is trusted only if both stretches show their marker and the
    second shows twice the first's kernels, within 2%; it is then the second
    stretch's.  Reported, never gated on."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    marks = {"smoke_stretch_1": reps, "smoke_stretch_2": 2 * reps}
    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while True:
            fn()
            torch.cuda.synchronize()
            if time.perf_counter() - t0 > 0.1:
                break
        for mark, n in marks.items():
            with record_function(mark):
                for _ in range(n):
                    fn()
                marker.add_(1.0)
                torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    spans, seen = {}, []
    for e in prof.events():
        if e.name in marks:
            if e.device_type != on_card:
                spans[e.name] = (e.time_range.start, e.time_range.end)
        elif (e.device_type == on_card and "memcpy" not in e.name.lower()
              and "memset" not in e.name.lower()):
            seen.append((e.time_range.start, e.time_range.elapsed_us(),
                         any(h in e.name for h in HAND_KERNELS)))
    if len(spans) != 2:
        return -1, None, None
    counts = []
    for lo, hi in (spans[m] for m in marks):
        inside = sorted(k for k in seen if lo <= k[0] <= hi)
        by_torch = [us for _, us, hand in inside if not hand]
        if not by_torch:  # not even the marker
            return -1, None, None
        counts.append((len(by_torch) - 1, sum(by_torch[:-1]), len(inside) - len(by_torch)))
    (n1, _, _), (n2, us2, hand2) = counts
    if abs(n2 - 2 * n1) > 0.02 * n2:
        return -1, None, None
    return n2 / (2 * reps), us2 / (2 * reps) / 1e3, hand2 / (2 * reps)


def _queued_ms(fn, reps: int = 50):
    """Device ms per call of ``fn`` with the host out of the way, by CUDA
    events: a spin kernel holds the stream while the host queues ``reps``
    calls, so the events bracket the kernels running back to back.  None if
    the host was still queueing when the spin ended."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(HOLD_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].synchronize()
    if queued_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / reps


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
    # One process pool renders the 8-frame chain, the pan + teleport, and
    # the second sequence of phase 8's batch.
    cfg = SystemConfig()
    cam = cfg.camera
    scene = SyntheticScene()
    t0 = time.perf_counter()
    trajs = [scene.trajectory(N_FRAMES, seed=0), pan_sequence(N_PAN),
             scene.trajectory(N_PAN, seed=1)]
    rendered = render_trajectory_parallel(
        scene, cam, np.concatenate(trajs), seed=0, workers=max(os.cpu_count() - 1, 1)
    )
    grays, depths, gt = _sensor_frames(rendered[:N_FRAMES], cfg)
    pan = _sensor_frames(rendered[N_FRAMES:N_FRAMES + N_PAN + 1], cfg)
    second = _sensor_frames(rendered[N_FRAMES + N_PAN + 1:], cfg)
    _phase("frames", n=len(rendered), shape=list(grays[0].shape),
           seconds=round(time.perf_counter() - t0, 3))

    # -- 5. main path (run before phase 4, which needs its frames) ----------
    counters_ = (K12.canny_nms, K12.canny_hysteresis, K3.lgsx_reduce, K3.residual_lgsx)
    all_kernels = ["canny_nms", "canny_hysteresis", "residual_lgsx"]  # of the paths
    gpu, launches = _path_launches(counters_, lambda: {
        name: _run_chain(grays, depths, _with_solver(cfg, name), dev)
        for name in ("lm", "gn_fixed")
    })
    _require_launched("main", launches, all_kernels)
    launch_total = dict(launches)

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
            r_p = K12.hysteresis_ref(c_p, s_p)
            if not K12.hysteresis_fits_shared(dev, *c_p.shape[1:]):
                raise RuntimeError(f"K2: level {lvl} does not take the shared-memory form")
            n_diff = int((c_k != c_p).sum() + (s_k != s_p).sum())
            h_diff = sum(int((K12.canny_hysteresis(c_p, s_p, _form=form) != r_p).sum())
                         for form in (None, "shared", "global"))
            if n_diff or h_diff:
                raise RuntimeError(
                    f"K1/K2 differ from plain at level {lvl} B={batch.shape[0]}: "
                    f"{n_diff} NMS, {h_diff} hysteresis pixels"
                )
            k12_diff = max(k12_diff, n_diff, h_diff)
    # K2 where the cap binds (the snake is not covered) and on ragged rows.
    for shape in ((24, 64), (23, 41), (120, 200)):
        c_p, s_p = (torch.from_numpy(m).to(dev) for m in serpentine(*shape))
        r_p = K12.hysteresis_ref(c_p, s_p)
        if not 0 < int(r_p.sum()) < int(c_p.sum()):
            raise RuntimeError(f"K2: the cap does not bind on the {shape} serpentine")
        for form in ("shared", "global"):
            h_diff = int((K12.canny_hysteresis(c_p, s_p, _form=form) != r_p).sum())
            if h_diff:
                raise RuntimeError(f"K2 ({form}) differs from plain on the {shape} "
                                   f"serpentine: {h_diff} pixels")
    k12_err = float(min(k12_diff, 1))  # max |kernel - plain| of 0/1 masks
    opt = cfg.tracker.optimizer
    cams = cfg.camera_pyramid()
    k3_err, k3_rel = 0.0, 0.0
    poses = [(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
             (results_lm[-1].R, results_lm[-1].t)]
    for lvl in range(cfg.pyramid.n_levels):
        for R, t in poses:
            terms = K3.residual_terms(
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
    # Fused K3, the solver's one launch per evaluation, with a third pose
    # that throws most points out of the image, on both quad forms.
    from revo_tpu_torch import lie
    from revo_tpu_torch.ops.edt import quad_structure

    poses.append(tuple(x.to(dev) for x in lie.exp_se3(
        torch.tensor([0.9, -0.3, 0.1, 0.03, 0.4, -0.08]))))
    fused_err, fused_rel, fused_cases, fused_counts = 0.0, 0.0, 0, []
    for lvl in range(cfg.pyramid.n_levels):
        tables = (kf_lm.quads[lvl], quad_structure(kf_lm.structs[lvl], "dt4"))
        if [q.dtype for q in tables] != [torch.bfloat16, torch.float32]:
            raise RuntimeError("fused K3: want a dt4bf and a dt4 table")
        for quad in tables:
            for R, t in poses:
                args = (quad, frames_lm[-1].levels[lvl].cloud, cams[lvl], R, t,
                        opt.edge_distance_lvl[lvl], opt.huber_edge, opt.use_edge_filter)
                before = K3.residual_lgsx.launches
                torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
                got = solver._residual_sums(*args)
                torch.cuda.set_sync_debug_mode("default")
                if K3.residual_lgsx.launches != before + 1:
                    raise RuntimeError("fused K3: an evaluation is not one launch")
                again = K3.residual_lgsx(*args)
                want = K3.residual_lgsx_ref(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise RuntimeError(f"fused K3: two launches differ at level {lvl}")
                counts = [int(got[4]), int(got[5]), int(want[4]), int(want[5])]
                if counts[:2] != counts[2:]:
                    raise RuntimeError(f"fused K3: (good, bad) {counts[:2]} != plain "
                                       f"{counts[2:]} at level {lvl}, {quad.dtype}")
                fused_counts.append(counts[:2])
                for a, b in zip(got[:4], want[:4]):
                    err = float((a - b).abs().max())
                    fused_err = max(fused_err, err)
                    fused_rel = max(fused_rel, err / max(float(b.abs().max()), 1e-30))
                fused_cases += 1
    if not fused_rel <= K3_RTOL:
        raise RuntimeError(f"fused K3 differs from plain by {fused_rel} (relative) > {K3_RTOL}")
    if not any(bad > good for good, bad in fused_counts):
        raise RuntimeError(f"fused K3: no case with most points out of bounds: {fused_counts}")
    _phase("kernels", k1_k2_differing_pixels=k12_diff, k3_max_abs_err=k3_err,
           k3_max_rel_err=k3_rel, k3_rtol=K3_RTOL, fused_k3_cases=fused_cases,
           fused_k3_max_abs_err=fused_err, fused_k3_max_rel_err=fused_rel,
           fused_k3_good_bad=fused_counts)
    _phase("main", **summary)

    from revo_tpu_torch.autotune import calibrate_capacities
    from revo_tpu_torch.io.tum import read_tum_trajectory
    from revo_tpu_torch.parallel import batch
    from revo_tpu_torch.system import VOSystem

    def add_launches(counts):
        for k, v in counts.items():
            launch_total[k] += v

    # -- 7. vo: VOSystem.run over the pan + teleport -------------------------
    p_grays, p_depths, p_gt = pan
    with tempfile.TemporaryDirectory() as tmp:
        pose_file = os.path.join(tmp, "poses.txt")

        def card_vo():
            vo = VOSystem(cfg, device=dev)
            return vo, run_teleport(vo, p_grays, p_depths, pose_file,
                                    lambda a: torch.from_numpy(a).to(dev))

        (vo_card, (poses_c, flags_c, report_c)), launches = _path_launches(counters_, card_vo)
        _require_launched("vo", launches, all_kernels)
        add_launches(launches)
        _, file_poses = read_tum_trajectory(pose_file)
    vo_cpu = VOSystem(cfg, device="cpu")
    poses_h, flags_h, _ = run_teleport(vo_cpu, p_grays, p_depths, None, torch.from_numpy)
    vo_dt, vo_dr = _max_pose_diff(poses_c, poses_h)
    vo_ate = absolute_trajectory_error(poses_c, p_gt).rmse
    file_dt, file_dr = _max_pose_diff(file_poses, poses_c)
    vo_summary = {
        "frames": report_c.frames_tracked, "keyframes": report_c.keyframes,
        "relocalized": vo_card.n_relocalized, "lost": report_c.tracking_lost,
        "promoted_at": (np.flatnonzero(flags_c[1:, 0] > 0) + 1).tolist(),
        "relocalized_at": np.flatnonzero(flags_c[:, 1] > 0).tolist(),
        "latency_ms_p50": report_c.latency_ms_p50, "latency_ms_p95": report_c.latency_ms_p95,
        "latency_ms_p99": report_c.latency_ms_p99,
        "mean_tracking_ms": report_c.mean_tracking_time_ms,
        "mean_keyframe_ms": report_c.mean_dt_time_ms,
        "ate_m": vo_ate, "ate_limit_m": VO_ATE_LIMIT_M, "vs_cpu_m": vo_dt, "vs_cpu_rad": vo_dr,
        "tum_file_vs_run_m": file_dt, "tum_file_vs_run_rad": file_dr,
        "launches": launches, "smi": smi,
    }
    if not (flags_c[1:, 0].sum() >= 1 and flags_c[:, 1].sum() >= 1 and flags_c[:, 2].sum() == 0):
        raise RuntimeError(f"vo: want >= 1 promotion, >= 1 relocalization, 0 lost: {vo_summary}")
    if not np.array_equal(flags_c, flags_h):
        raise RuntimeError(f"vo: card flags {flags_c.tolist()} != CPU flags {flags_h.tolist()}")
    if not (vo_dt <= POSE_TOL and vo_dr <= POSE_TOL and np.isfinite(poses_c).all()):
        raise RuntimeError(f"vo: card poses differ from CPU by {vo_dt} m, {vo_dr} rad")
    if not vo_ate < VO_ATE_LIMIT_M:
        raise RuntimeError(f"vo: ATE {vo_ate} m >= {VO_ATE_LIMIT_M} m")
    if not (file_poses.shape == poses_c.shape and file_dt <= TUM_TOL_M and file_dr <= TUM_TOL_RAD):
        raise RuntimeError(f"vo: TUM file reads back {file_dt} m, {file_dr} rad off the run")
    _phase("vo", **vo_summary)

    # -- 8. scan: vo_scan over the pan, and B=2 batched ----------------------
    def stack(frames_):
        return torch.from_numpy(np.stack(frames_[:N_PAN])).to(dev)

    g_pan, d_pan = stack(p_grays), stack(p_depths)
    g_two, d_two = stack(second[0]), stack(second[1])

    def card_scan():
        scan = batch.vo_scan(g_pan, d_pan, cfg)
        two = batch.vo_scan(g_two, d_two, cfg)[0]
        lanes = batch.vo_scan_batched(torch.stack([g_pan, g_two]), torch.stack([d_pan, d_two]), cfg)
        return scan, two, lanes

    ((poses_s, outs_s, _), poses_two, lanes), launches = _path_launches(counters_, card_scan)
    _require_launched("scan", launches, all_kernels)
    add_launches(launches)
    poses_s = poses_s.cpu().numpy().astype(np.float64)
    promoted_s = outs_s.promoted.cpu().numpy()
    sc_dt, sc_dr = _max_pose_diff(poses_s, poses_c[:N_PAN])
    scan_summary = {
        "frames": N_PAN, "promoted_at": np.flatnonzero(promoted_s).tolist(),
        "relocalized": int(outs_s.relocalized.sum()), "lost": int(outs_s.lost.sum()),
        "vs_vosystem_m": sc_dt, "vs_vosystem_rad": sc_dr, "tol": SCAN_TOL,
        "ate_m": absolute_trajectory_error(poses_s, p_gt[:N_PAN]).rmse,
        "ate_second_m": absolute_trajectory_error(
            poses_two.cpu().numpy().astype(np.float64), second[2]).rmse,
        "launches": launches, "smi": smi,
    }
    want_promoted = flags_c[:N_PAN, 0] > 0
    want_promoted[0] = False  # frame 0 is the first keyframe, not a promotion
    if not (np.array_equal(promoted_s, want_promoted) and scan_summary["relocalized"] == 0
            and scan_summary["lost"] == 0):
        raise RuntimeError(f"scan: flags differ from VOSystem's: {scan_summary}")
    if not (sc_dt <= SCAN_TOL and sc_dr <= SCAN_TOL):
        raise RuntimeError(f"scan: poses differ from VOSystem by {sc_dt} m, {sc_dr} rad")
    if not (lanes.shape == (2, N_PAN, 4, 4) and torch.equal(lanes[0], outs_s.T_w)
            and torch.equal(lanes[1], poses_two)):
        raise RuntimeError("scan: vo_scan_batched lanes differ from vo_scan")
    _phase("scan", **scan_summary)

    # -- 9. autotune: capacities from the first 2 frames ---------------------
    def calibrate(device):
        return calibrate_capacities(cfg, p_grays[:2], p_depths[:2], margin=CAPACITY_MARGIN,
                                    device=device).pyramid.edge_capacity

    caps_card, launches = _path_launches(counters_, lambda: calibrate(dev))
    _require_launched("autotune", launches, all_kernels[:2])
    add_launches(launches)
    caps_cpu = calibrate("cpu")
    if caps_card != caps_cpu:
        raise RuntimeError(f"autotune: card capacities {caps_card} != CPU {caps_cpu}")
    _phase("autotune", margin=CAPACITY_MARGIN, edge_capacity=list(caps_card),
           launches=launches)

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
        # Device kernels and busy time of one tracked frame, and how many of
        # its kernels an evaluation (one fused K3 launch) accounts for.
        before = K3.residual_lgsx.launches
        chain()
        evals = K3.residual_lgsx.launches - before
        n_kern, busy_ms, _ = _profile_kernels(chain)
        stage_ms[f"track_frames_{name}_profile"] = {
            "torch_kernels_per_frame": None if busy_ms is None else n_kern / (N_FRAMES - 1),
            "evaluations_per_frame": evals / (N_FRAMES - 1),  # one fused K3 launch each
            "torch_busy_ms_per_frame": None if busy_ms is None else busy_ms / (N_FRAMES - 1),
        }

    # The VO loops over the pan, warmed up by phases 7 and 8.
    timed = {}

    def vo_pan():
        timed["vo"] = VOSystem(cfg, device=dev)
        timed["vo"].run(zip(p_grays[:N_PAN], p_depths[:N_PAN], np.arange(N_PAN) / 30.0))

    stage_ms["process_frame"] = _time_ms(vo_pan, 1, warmup=0) / N_PAN
    rep = timed["vo"].report()
    stage_ms["process_frame_p50_p95_p99"] = [
        rep.latency_ms_p50, rep.latency_ms_p95, rep.latency_ms_p99]
    stage_ms["vo_scan_frame"] = _time_ms(
        lambda: batch.vo_scan(g_pan, d_pan, cfg), 1, warmup=0) / N_PAN

    gp0 = _reflect_pad(frames_lm[1].levels[0].gray[None], 1, 1).contiguous()
    c0, s0 = K12.canny_nms_ref(gp0, lo, hi)
    # Steps this frame's fixpoint needs: the plain loop runs its last trip of
    # 8 to the end although that trip's first step already grows nothing.
    k2_trips = K12.hysteresis_steps_ref(c0, s0)[1]
    k2_steps = k2_trips if k2_trips >= sum(c0.shape[1:]) else k2_trips - 7
    fused0 = (kf_lm.quads[0], frames_lm[-1].levels[0].cloud, cams[0],
              results_lm[-1].R, results_lm[-1].t,
              opt.edge_distance_lvl[0], opt.huber_edge, opt.use_edge_filter)
    terms0 = K3.residual_terms(*fused0)[:4]
    cloud0 = fused0[1]
    n_pix, n_pts = c0.numel(), cloud0.points.shape[0]
    # Bounds: each input read once, each output written once; the fused form
    # gathers one sector per point that lands inside the image (the rest
    # read no row), not the whole table.
    n_inside0 = int(K3.residual_terms(*fused0[:7], False)[5])  # edge filter off
    gathered = n_inside0 * GATHER_SECTOR_BYTES
    floor_gp = torch.zeros((1, 18, 18), device=dev)
    kern = [
        ("canny_nms", "canny.cu", "revo_tpu/ops/pallas/canny_kernel.py:127",
         lambda: K12.canny_nms(gp0, lo, hi),
         lambda: K12.canny_nms_ref(gp0, lo, hi), k12_err,
         _bound(_nbytes(gp0) + 2 * n_pix, K1_OPS_PER_PIXEL * n_pix)),
        ("canny_hysteresis", "canny.cu", "revo_tpu/ops/pallas/hysteresis.py:102",
         lambda: K12.canny_hysteresis(c0, s0),
         lambda: K12.hysteresis_ref(c0, s0), k12_err,
         _bound(3 * n_pix, K2_OPS_PER_WORD_STEP * (n_pix / 32) * k2_steps)),
        ("lgsx_reduce", "lgsx.cu", "revo_tpu/ops/pallas/lgsx.py:103",
         lambda: K3.lgsx_reduce(*terms0),
         lambda: K3.lgsx_reduce_ref(*terms0), k3_err,
         _bound(_nbytes(*terms0) + 43 * 4, K3_OPS_PER_POINT * n_pts)),
        ("residual_lgsx", "lgsx.cu", "revo_tpu/ops/pallas/lgsx.py:103",
         lambda: K3.residual_lgsx(*fused0),
         lambda: K3.residual_lgsx_ref(*fused0), fused_err,
         _bound(_nbytes(cloud0.points, cloud0.valid, fused0[3], fused0[4]) + gathered + 46 * 4,
                K3_FUSED_OPS_PER_POINT * n_pts)),
    ]
    rows = []
    for name, src, replaces, fk, fp, err, (bound_ms, bound_by) in kern:
        ms_k, ms_p = _time_ms(fk, 50), _time_ms(fp, 50)
        ms_k2, ms_p2 = _time_ms(fk, 50), _time_ms(fp, 50)
        rows.append({
            "name": name, "route": "cuda", "source": f"revo_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launch_total[name],
            "max_abs_err": err, "ms": min(ms_k, ms_k2), "plain_ms": min(ms_p, ms_p2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes any of these
            # The kernel alone on the device (launches queued behind a
            # spin); "ms" above is the rate at which the host can launch it.
            "device_ms": _queued_ms(fk),
        })
    # The launch floor (K1 on a 16x16 image: what one launch through ctypes
    # costs), K2's global-memory form beside the shared one, and how many
    # device kernels one evaluation is now and was as torch ops.
    launch_floor_ms = min(_time_ms(lambda: K12.canny_nms(floor_gp, lo, hi), 50) for _ in range(2))
    k2_global_ms = min(
        _time_ms(lambda: K12.canny_hysteresis(c0, s0, _form="global"), 50) for _ in range(2))
    def kernels_of(fn):
        before = K3.residual_lgsx.launches
        fn()
        hand = K3.residual_lgsx.launches - before
        by_torch, _, shown = _profile_kernels(fn, 20)
        return {"hand_launches": hand,
                "torch_kernels": by_torch, "hand_kernels_profiler_showed": shown}

    eval_kernels = {
        "residual_sums": kernels_of(lambda: solver._residual_sums(*fused0)),
        "residual_sums_plain": kernels_of(lambda: K3.residual_lgsx_ref(*fused0)),
        "residual_system": kernels_of(lambda: solver.residual_system(*fused0)),
    }
    _phase("times", smi=smi, stage_ms_per_frame=stage_ms,
           kernel_ms={r["name"]: [r["ms"], r["plain_ms"]] for r in rows},
           bound_ms={r["name"]: [r["bound_ms"], r["bound_by"]] for r in rows},
           device_ms={r["name"]: r["device_ms"] for r in rows},
           launch_floor_ms=launch_floor_ms, canny_hysteresis_global_ms=k2_global_ms,
           k2_steps=k2_steps, kernels_per_evaluation=eval_kernels,
           launches_per_pan_frame={k: v / (N_PAN + 1) for k, v in vo_summary["launches"].items()})

    # "kernels": those of the main paths, each launched there; the unfused
    # K3 is held against its plain version and timed like them, but no path
    # launches it any more, so it is listed apart.
    print(json.dumps({"kernels": [r for r in rows if r["name"] in all_kernels],
                      "kernels_off_path": [r for r in rows if r["name"] not in all_kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
