"""A/B of revo_tpu_torch's one-lane path between two trees, on one card.

Times what a single sequence pays per frame, in the order OTHER, THIS,
THIS, OTHER, each in a process of its own that imports ``revo_tpu_torch``
from its tree and builds that tree's kernels:

- ``track_frames`` (``lm`` and ``gn_fixed``) over an 8-frame 640x480 chain
  against frame 0's keyframe, each frame from the last one's pose: wall ms
  per tracked frame (synchronized), the best of three passes after one
  warm-up pass, the fused K3 launches (evaluations) per tracked frame, and
  the device kernels of one tracked frame (torch.profiler);
- ``VOSystem.process_frame`` over a 20-frame lateral pan: wall ms per frame,
  mean and p50 over two passes after a warm-up pass;
- the fused K3 at level 0 of the last chain frame, host ms per call (the
  mean of 200 calls closed by one synchronize): the one-lane wrapper
  ``residual_lgsx``, and the call the solver makes per evaluation (in a tree
  with ``lane_operands``, ``residual_lgsx_lanes`` on operands checked once;
  before it, ``residual_lgsx`` itself).

Usage (OTHER is an unpacked tree of another commit, e.g. ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 scripts/ab_torch_one_lane.py --other build/ab_parent

Prints one JSON object per worker and, as its last line, the summary with
the card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CHAIN, N_PAN = 8, 20
PAN_STEP = (0.04, 0.0, 0.005, 0.0, 0.017, 0.0)  # chip_smoke.py's pan


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def render(path: str) -> None:
    """The chain (seeded trajectory 0) and the pan as uint8 gray and
    uint16 depth at the default 640x480 camera, into ``path``."""
    import multiprocessing as mp

    import torch

    sys.path.insert(0, THIS)
    from revo_tpu_torch import lie
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.io.synthetic import SyntheticScene, _render_one

    cfg = SystemConfig()
    scene = SyntheticScene()
    step = lie.matrix_from_rt(*lie.exp_se3(torch.tensor(PAN_STEP))).numpy()
    pan, T = [], np.eye(4, dtype=np.float32)
    for _ in range(N_PAN):
        pan.append(T.copy())
        T = T @ step
    poses = list(scene.trajectory(N_CHAIN, seed=0)) + pan
    jobs = [(scene, cfg.camera, T, i) for i, T in enumerate(poses)]
    with mp.get_context("spawn").Pool(max(os.cpu_count() - 1, 1)) as pool:
        outs = pool.map(_render_one, jobs, chunksize=2)
    scale = cfg.dataset.depth_scale_factor
    np.savez(path, grays=np.stack([g.astype(np.uint8) for g, _ in outs]),
             depths=np.stack([(d * scale).astype(np.uint16) for _, d in outs]))


def _kernels_of(fn) -> int:
    """Device kernels (copies and fills left out) of one call of ``fn``,
    by torch.profiler; one warm-up call opens the window.  -1 if the marked
    call is not in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("ab_marked"):
            fn()
            torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    span = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == "ab_marked" and e.device_type != on_card]
    if not span:
        return -1
    lo, hi = span[0]
    # A device event of a host event's name is a range's copy on the device
    # timeline (the mark, the program's spans), not a kernel.
    host_names = {e.name for e in prof.events() if e.device_type != on_card}
    return sum(1 for e in prof.events()
               if e.device_type == on_card and lo <= e.time_range.start <= hi
               and e.name not in host_names
               and not any(w in e.name.lower() for w in ("memcpy", "memset", "sync")))


def _host_ms(fn, reps: int = 200) -> float:
    """Host ms per call of ``fn``: ``reps`` calls closed by one synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def worker(root: str, frames_path: str) -> dict:
    import dataclasses

    sys.path.insert(0, root)
    import torch

    import revo_tpu_torch
    from revo_tpu_torch import frontend, kernels, tracker
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.ops import lgsx as K3
    from revo_tpu_torch.system import VOSystem

    if not revo_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {revo_tpu_torch.__file__}, not the tree at {root}")
    kernels.library()
    data = np.load(frames_path)
    dev = torch.device("cuda")
    grays = torch.from_numpy(data["grays"]).to(dev)
    depths = torch.from_numpy(data["depths"]).to(dev)
    out = {"root": root}
    for name in ("lm", "gn_fixed"):
        opt = dataclasses.replace(SystemConfig().tracker.optimizer, solver=name)
        cfg = SystemConfig()
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt))
        frames = [frontend.build_frame(grays[i], depths[i], cfg) for i in range(N_CHAIN)]
        kf = frontend.make_keyframe(frames[0], torch.eye(4, device=dev), cfg)

        def chain():
            R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
            for f in frames[1:]:
                res = tracker.track_frames(kf, f, R, t, cfg)
                R, t = res.R, res.t
            return R, t

        chain()
        passes = []
        for _ in range(3):
            torch.cuda.synchronize()
            K3.residual_lgsx.launches = 0
            t0 = time.perf_counter()
            chain()
            torch.cuda.synchronize()
            passes.append(1e3 * (time.perf_counter() - t0) / (N_CHAIN - 1))
        R0, t0_ = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        out[f"track_{name}_ms"] = min(passes)
        out[f"track_{name}_passes_ms"] = passes
        out[f"track_{name}_evaluations"] = K3.residual_lgsx.launches / (N_CHAIN - 1)
        out[f"track_{name}_kernels"] = _kernels_of(
            lambda: tracker.track_frames(kf, frames[1], R0, t0_, cfg))
        if name == "lm":
            cloud = frames[-1].levels[0].cloud
            cam0 = cfg.camera
            o = cfg.tracker.optimizer
            args = (kf.quads[0], cloud, cam0, R0, t0_, o.edge_distance_lvl[0], o.huber_edge,
                    o.use_edge_filter)
            out["residual_lgsx_host_ms"] = _host_ms(lambda: K3.residual_lgsx(*args))
            if hasattr(K3, "lane_operands"):
                one = cloud._replace(points=cloud.points[None], valid=cloud.valid[None])
                ops = K3.lane_operands(kf.quads[0][None], one, cam0, 1)
                out["residual_lgsx_solver_host_ms"] = _host_ms(lambda: K3.residual_lgsx_lanes(
                    ops, R0[None], t0_[None], *args[5:]))
            else:
                out["residual_lgsx_solver_host_ms"] = out["residual_lgsx_host_ms"]
    cfg = SystemConfig()
    per_frame = []
    for p in range(3):
        vo = VOSystem(cfg, device=dev)
        for i in range(N_CHAIN, N_CHAIN + N_PAN):
            t0 = time.perf_counter()
            vo.process_frame(data["grays"][i], data["depths"][i], i / 30.0)
            if p:
                per_frame.append(1e3 * (time.perf_counter() - t0))
    out["process_frame_mean_ms"] = float(np.mean(per_frame))
    out["process_frame_p50_ms"] = float(np.median(per_frame))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "FRAMES"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(*args.worker)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_one_lane: needs a CUDA card")
    other = os.path.abspath(args.other)
    os.makedirs(os.path.join(THIS, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(THIS, "build")) as tmp:
        frames = os.path.join(tmp, "frames.npz")
        render(frames)
        runs = []
        for root in (other, THIS, THIS, other):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                                   frames], capture_output=True, text=True, cwd=root)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"worker for {root} failed ({proc.returncode})")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in runs[0] if k.endswith(("_ms", "_kernels", "_evaluations"))]
    summary = {k: {"other": [runs[0][k], runs[3][k]], "this": [runs[1][k], runs[2][k]]}
               for k in keys}
    print(_smi())
    print(json.dumps({"ab_one_lane": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
