"""A/B of the solver's level kernel (csrc/level.cu, ``revo_solve_level``)
between two trees on one card, and the split of one evaluation into its
parts.

Timing workers run in the order OTHER, THIS, THIS, OTHER, each a process of
its own that imports ``revo_tpu_torch`` from its tree and builds that tree's
kernels, on the same rendered 640x480 chain (seeded trajectory 0, frame 0
the keyframe, frames 1..7 tracked in turn):

- the level kernel alone (``solve_level_kernel``) at levels 2 / 1 / 0, B =
  1 / 8 / 32 lanes (frames 1..7 in turn, each level from the pose the level
  above gave, as ``track_frames`` runs them), ``lm`` and ``gn_fixed``:
  device ms of one launch (launches queued behind a spin kernel, CUDA
  events), the slowest lane's evaluations and us an evaluation of it;
  registers, local and shared bytes a thread / block
  (``solver.level_attributes``); in a tree whose kernel takes the init
  check, the level-2 launch with and without it;
- ``track_frames`` over the chain (``lm``, ``gn_fixed``): ms a frame, best
  of three passes;
- the batched step (``build_frame_batched`` + ``track_frames_batched`` from
  the identity, chip_smoke phase 18 (e)'s step at its capacities) at B = 1
  / 8 / 32: ms a step, best of two.

``--split`` adds, for OTHER and then THIS, a worker on a copy of the tree
whose ``csrc/level.cu`` this script rewrites with ``clock64`` stamps (and
``%globaltimer`` beside them, for the SM clock) at the parts of an
evaluation; the copy exports ``revo_level_stamps``, which reads them back.
The stamps go in at lines this script knows in the two forms of level.cu
it was written for (the one-thread step with two cluster barriers an
evaluation, and the replicated step with one); another form raises.  Parts
of an evaluation, on rank 0's clock: the pass (its own; and the slowest
rank's, each on its own clock), the wait at the first barrier, the ordered
sum, the step, and what comes before the next evaluation's pass (the
second barrier and the reload, where there are two barriers).  Levels 2 and
0, B = 1 and 8, ``lm``; lanes 0..7 are stamped.

Usage (OTHER: an unpacked tree of another commit, e.g. ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 scripts/ab_level.py --other build/ab_parent [--split]
    python3 scripts/ab_level.py --split-only        # this tree's split alone

Prints one JSON object per worker and, as its last two lines, the card's
name and power limit and the summary.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CHAIN = 8
LEVEL_LANES = (1, 8, 32)
STEP_LANES = (1, 8, 32)
STEP_CAPS = (8192, 4864, 2304)  # chip_smoke.py BATCH_CAPS
SPLIT_CASES = ((2, 1), (2, 8), (0, 1), (0, 8))  # (level, lanes)
HOLD_CYCLES = 60_000_000  # chip_smoke.py's spin: ~30 ms while launches queue
N_STAMPED_LANES, N_RANKS, N_EVALS, N_MARKS = 8, 8, 64, 6


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def render(path: str) -> None:
    """The chain as uint8 gray and uint16 depth at the default camera."""
    import multiprocessing as mp

    sys.path.insert(0, THIS)
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.io.synthetic import SyntheticScene, _render_one

    cfg = SystemConfig()
    scene = SyntheticScene()
    jobs = [(scene, cfg.camera, T, i) for i, T in enumerate(scene.trajectory(N_CHAIN, seed=0))]
    with mp.get_context("spawn").Pool(max(min(os.cpu_count() - 1, N_CHAIN), 1)) as pool:
        outs = pool.map(_render_one, jobs)
    scale = cfg.dataset.depth_scale_factor
    np.savez(path, grays=np.stack([g.astype(np.uint8) for g, _ in outs]),
             depths=np.stack([(d * scale).astype(np.uint16) for _, d in outs]))


# -- the stamped copy of level.cu ----------------------------------------------

_STAMP_HEAD = r"""
__device__ long long g_lv_stamps[8][8][64][6][2];  // lane, rank, evaluation, mark, (clock, ns)
#define LV_STAMP(k)                                                                  \
  do {                                                                               \
    if (threadIdx.x == 0 && blockIdx.y < 8 && lv_n < 64) {                           \
      long long ns_;                                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                        \
      g_lv_stamps[blockIdx.y][cg::this_cluster().block_rank()][lv_n][k][0] = clock64(); \
      g_lv_stamps[blockIdx.y][cg::this_cluster().block_rank()][lv_n][k][1] = ns_;    \
    }                                                                                \
  } while (0)
"""

_STAMP_TAIL = r"""
extern "C" int revo_level_stamps(void* out, int clear) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess && out) err = cudaMemcpyFromSymbol(out, g_lv_stamps, sizeof(g_lv_stamps));
  if (err == cudaSuccess && clear) {
    static long long zero[sizeof(g_lv_stamps) / sizeof(long long)];
    err = cudaMemcpyToSymbol(g_lv_stamps, zero, sizeof(g_lv_stamps));
  }
  return (int)err;
}
"""

# (anchor, what replaces it) for each form of level.cu: marks 0 pass start,
# 1 pass done, 2 past the barrier, 3 sums done, 4 step done, 5 past the
# second barrier (the two-barrier form).
_FORMS = {
    "two_barriers": [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + _STAMP_HEAD),
        ("  auto evaluate = [&]() {\n", "  int lv_n = 0;\n  auto evaluate = [&]() {\n    LV_STAMP(0);\n"),
        ("    }\n    cluster.sync();\n    if (rank == 0) {\n",
         "    }\n    LV_STAMP(1);\n    cluster.sync();\n    LV_STAMP(2);\n    if (rank == 0) {\n"),
        ("      residual::store_outputs(sums, tid, fs, is);\n      __syncthreads();\n",
         "      residual::store_outputs(sums, tid, fs, is);\n      __syncthreads();\n"
         "      LV_STAMP(3);\n"),
        ("a.t0_stride, 1, p);\n  cluster.sync();\n",
         "a.t0_stride, 1, p);\n  LV_STAMP(4);\n  cluster.sync();\n  LV_STAMP(5);\n  ++lv_n;\n"),
        ("a.t0_stride, 0, p);\n    cluster.sync();\n",
         "a.t0_stride, 0, p);\n    LV_STAMP(4);\n    cluster.sync();\n    LV_STAMP(5);\n"
         "    ++lv_n;\n"),
    ],
    "one_barrier": [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + _STAMP_HEAD),
        # the loop's evaluation i at index i + 1, as in the two-barrier form
        ("  auto evaluate = [&](", "  int lv_n = 1;\n  auto evaluate = [&]("),
        ("    // -- the pass\n", "    LV_STAMP(0);\n"),
        ("    // -- the barrier\n", "    LV_STAMP(1);\n"),
        ("    // -- the ordered sum\n", "    LV_STAMP(2);\n"),
        ("    // -- the step\n", "    LV_STAMP(3);\n"),
        ("    // -- the step done\n", "    LV_STAMP(4);\n    LV_STAMP(5);\n    ++lv_n;\n"),
    ],
}


def stamped_copy(root: str, dest: str) -> str:
    """A copy of ``root``'s package in ``dest`` with the stamps in its
    level.cu; returns the form found."""
    shutil.copytree(os.path.join(root, "revo_tpu_torch"), os.path.join(dest, "revo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dest, "revo_tpu_torch", "csrc", "level.cu")
    src = open(path).read()
    for form, edits in _FORMS.items():
        if all(src.count(anchor) == 1 for anchor, _ in edits):
            for anchor, repl in edits:
                src = src.replace(anchor, repl)
            with open(path, "w") as f:
                f.write(src + _STAMP_TAIL)
            return form
    raise RuntimeError(f"{path}: not a form of level.cu this script knows")


# -- workers ---------------------------------------------------------------------

def _queued_ms(fn, reps: int = 20):
    """Device ms per call of ``fn``, launches queued behind a spin kernel
    (chip_smoke.py's ``_queued_ms``); None if the host was still queueing
    when the spin ended."""
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


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _setup(root: str, frames_path: str):
    sys.path.insert(0, root)
    import torch

    import revo_tpu_torch
    from revo_tpu_torch import frontend, kernels, tracker
    from revo_tpu_torch.config import SystemConfig

    if not revo_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {revo_tpu_torch.__file__}, not the tree at {root}")
    kernels.library()
    data = np.load(frames_path)
    dev = torch.device("cuda")
    grays = torch.from_numpy(data["grays"]).to(dev)
    depths = torch.from_numpy(data["depths"]).to(dev)
    cfg = SystemConfig()
    frames = [frontend.build_frame(grays[i], depths[i], cfg) for i in range(N_CHAIN)]
    kf = frontend.make_keyframe(frames[0], torch.eye(4, device=dev), cfg)
    R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    priors = []
    for f in frames[1:]:
        priors.append((R, t))
        res = tracker.track_frames(kf, f, R, t, cfg)
        R, t = res.R, res.t
    return dev, cfg, grays, depths, frames, kf, priors


def _level_cases(dev, cfg, frames, kf, priors, gn: bool, lanes):
    """Per level (2, 1, 0): (operands, start R, start t, params, edge
    distance), each level from the level kernel's result above it."""
    import torch

    from revo_tpu_torch import solver
    from revo_tpu_torch.ops import lgsx as K3
    from revo_tpu_torch.ops.backproject import EdgeCloud

    opt = dataclasses.replace(cfg.tracker.optimizer, solver="gn_fixed" if gn else "lm")
    cams = cfg.camera_pyramid()
    idx = [1 + b % (N_CHAIN - 1) for b in range(lanes)]
    R = torch.stack([priors[i - 1][0] for i in idx])
    t = torch.stack([priors[i - 1][1] for i in idx])
    out = {}
    for lvl in (2, 1, 0):
        cloud = EdgeCloud(torch.stack([frames[i].levels[lvl].cloud.points for i in idx]),
                          torch.stack([frames[i].levels[lvl].cloud.valid for i in idx]), None)
        quad = kf.quads[lvl][None].expand(lanes, *kf.quads[lvl].shape)
        ops = K3.lane_operands(quad, cloud, cams[lvl], lanes)
        p = solver.step_params(opt, lvl, gn, dev)
        out[lvl] = (ops, R, t, p, opt.edge_distance_lvl[lvl], opt, cloud, quad)
        state = solver.solve_level_kernel(ops, R, t, opt.edge_distance_lvl[lvl], opt, p)[0]
        R, t = state.R, state.t
    return out


def worker(root: str, frames_path: str) -> dict:
    import torch

    dev, cfg, grays, depths, frames, kf, priors = _setup(root, frames_path)
    from revo_tpu_torch import frontend, solver, tracker
    from revo_tpu_torch.lanes import add_lane_axis
    from revo_tpu_torch.ops import lgsx as K3

    out = {"root": root, "levels": [], "attributes": solver.level_attributes(
        dev, K3.table_layout(kf.quads[0]))}
    has_check = hasattr(solver, "init_check_block")
    for name, gn in (("lm", False), ("gn_fixed", True)):
        for lanes in LEVEL_LANES:
            for lvl, (ops, R, t, p, edge, opt, cloud, quad) in _level_cases(
                    dev, cfg, frames, kf, priors, gn, lanes).items():
                def run(ops=ops, R=R, t=t, p=p, edge=edge, opt=opt):
                    return solver.solve_level_kernel(ops, R, t, edge, opt, p)

                evals = int(run()[1].max())
                ms = _queued_ms(run)
                row = {"solver": name, "level": lvl, "B": lanes, "device_ms": ms,
                       "slowest_lane_evaluations": evals,
                       "us_an_evaluation": None if ms is None else 1e3 * ms / evals}
                if has_check and lvl == cfg.pyramid.pyr_min_lvl:
                    tr = cfg.tracker

                    def checked(ops=ops, R=R, t=t, p=p, edge=edge, opt=opt, quad=quad):
                        check = solver.init_check_block(
                            kf.structs[lvl][None].expand(lanes, *kf.structs[lvl].shape), lanes,
                            edge,
                            opt.use_edge_filter, tr.normalized_init_cost, tr.init_check_margin)
                        return solver.solve_level_kernel(ops, R, t, edge, opt, p, check=check)

                    row["with_init_check_device_ms"] = _queued_ms(checked)
                    row["with_init_check_evaluations"] = int(checked()[1].max())
                out["levels"].append(row)
    for name in ("lm", "gn_fixed"):
        opt = dataclasses.replace(cfg.tracker.optimizer, solver=name)
        c = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt))

        def chain(c=c):
            R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
            for f in frames[1:]:
                res = tracker.track_frames(kf, f, R, t, c)
                R, t = res.R, res.t
            return R, t

        chain()
        out[f"track_{name}_ms"] = min(_time_ms(chain, 1, 0) / (N_CHAIN - 1) for _ in range(3))
        c8 = dataclasses.replace(c, pyramid=dataclasses.replace(c.pyramid,
                                                                edge_capacity=STEP_CAPS))
        kf8 = frontend.make_keyframe(frontend.build_frame(grays[0], depths[0], c8),
                                     torch.eye(4, device=dev), c8)
        for lanes in STEP_LANES:
            idx = [1 + i % (N_CHAIN - 1) for i in range(lanes)]
            g_b = torch.stack([grays[i] for i in idx])
            d_b = torch.stack([depths[i] for i in idx])
            kf_b = add_lane_axis(kf8._replace(frame=None), lanes)
            R_b = torch.eye(3, device=dev).expand(lanes, 3, 3)
            t_b = torch.zeros((lanes, 3), device=dev)

            def step(c8=c8, g_b=g_b, d_b=d_b, kf_b=kf_b, R_b=R_b, t_b=t_b):
                f = frontend.build_frame_batched(g_b, d_b, c8)
                return tracker.track_frames_batched(kf_b, f, R_b, t_b, c8)

            out[f"step_{name}_B{lanes}_ms"] = min(_time_ms(step, 2, 1), _time_ms(step, 2, 0))
    return out


def split_worker(root: str, frames_path: str) -> dict:
    """The stamped copy at ``root``: per case the mean part times in us."""
    import ctypes

    import torch

    dev, cfg, _, _, frames, kf, priors = _setup(root, frames_path)
    from revo_tpu_torch import kernels, solver
    from revo_tpu_torch.ops import lgsx as K3

    fn = kernels.library().lib.revo_level_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = np.zeros((N_STAMPED_LANES, N_RANKS, N_EVALS, N_MARKS, 2), np.int64)
    out = {"root": root, "cases": []}
    reps = 30
    for lvl, lanes in SPLIT_CASES:
        ops, R, t, p, edge, opt, _, _ = _level_cases(dev, cfg, frames, kf, priors, False,
                                                     lanes)[lvl]
        parts = {k: [] for k in ("pass_rank0", "pass_slowest_rank", "barrier", "ordered_sum",
                                 "step", "to_next_pass", "evaluation")}
        rate = []
        for _ in range(reps):
            if fn(None, 1) != 0:
                raise RuntimeError("revo_level_stamps failed")
            state, evals = solver.solve_level_kernel(ops, R, t, edge, opt, p)
            torch.cuda.synchronize()
            if fn(buf.ctypes.data, 0) != 0:
                raise RuntimeError("revo_level_stamps failed")
            C = solver.level_cluster(dev, K3.table_layout(ops.quad), lanes, False)
            for b in range(min(lanes, N_STAMPED_LANES)):
                n = int(evals[b])  # lm: the start evaluation, then the loop's
                r0 = buf[b, 0, :, :, 0].astype(np.float64)
                ns = buf[b, 0, :, :, 1].astype(np.float64)
                if n >= 3:
                    rate.append((ns[n - 1, 4] - ns[1, 0]) / (r0[n - 1, 4] - r0[1, 0]))
                for e in range(1, n):  # the loop's evaluations
                    own = buf[b, :C, e, :, 0].astype(np.float64)
                    parts["pass_rank0"].append(r0[e, 1] - r0[e, 0])
                    parts["pass_slowest_rank"].append(float((own[:, 1] - own[:, 0]).max()))
                    parts["barrier"].append(r0[e, 2] - r0[e, 1])
                    parts["ordered_sum"].append(r0[e, 3] - r0[e, 2])
                    parts["step"].append(r0[e, 4] - r0[e, 3])
                    if e + 1 < n:
                        parts["to_next_pass"].append(r0[e + 1, 0] - r0[e, 4])
                        parts["evaluation"].append(r0[e + 1, 0] - r0[e, 0])
        ns_per_cycle = float(np.median(rate))
        out["cases"].append({
            "level": lvl, "B": lanes, "cluster": C, "ns_per_cycle": ns_per_cycle,
            "evaluations": int(evals.max()),
            "us": {k: float(np.mean(v)) * ns_per_cycle / 1e3 for k, v in parts.items() if v},
            "samples": len(parts["step"])})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--split", action="store_true", help="also split an evaluation into parts")
    ap.add_argument("--split-only", action="store_true", help="only this tree's split")
    ap.add_argument("--worker", nargs=3, metavar=("KIND", "ROOT", "FRAMES"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        kind, root, frames = args.worker
        print(json.dumps((split_worker if kind == "split" else worker)(root, frames)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_level: needs a CUDA card")
    os.makedirs(os.path.join(THIS, "build"), exist_ok=True)
    summary = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(THIS, "build")) as tmp:
        frames = os.path.join(tmp, "frames.npz")
        render(frames)

        def run(kind, root):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", kind,
                                   root, frames], capture_output=True, text=True, cwd=root)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"{kind} worker for {root} failed ({proc.returncode})")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(res), flush=True)
            return res

        other = os.path.abspath(args.other) if args.other else None
        if not args.split_only:
            if other is None:
                raise SystemExit("ab_level: --other is needed unless --split-only")
            runs = [run("time", root) for root in (other, THIS, THIS, other)]
            summary["time"] = {"other": [runs[0], runs[3]], "this": [runs[1], runs[2]]}
        if args.split or args.split_only:
            roots = [THIS] if args.split_only else [other, THIS]
            summary["split"] = {}
            for name, root in zip(("this",) if args.split_only else ("other", "this"), roots):
                copy = os.path.join(tmp, f"stamped_{name}")
                form = stamped_copy(root, copy)
                summary["split"][name] = {"form": form, **run("split", copy)}
    print(_smi())
    print(json.dumps({"ab_level": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
