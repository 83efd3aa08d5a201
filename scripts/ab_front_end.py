"""A/B of revo_tpu_torch's front end and keyframe between two trees, on one card.

Times ``build_frame`` and ``make_keyframe`` of a 640x480 frame (uint8 gray,
uint16 depth, default config: 3 levels, ``dt4bf``) at B = 1 and, batched,
at B = 8, in the order OTHER, THIS, THIS, OTHER, each in a process of its
own that imports ``revo_tpu_torch`` from its tree and builds that tree's
kernels.  For each: ms a call (CUDA events over 10 calls after warm-up,
best of two), the device kernels torch launches a call (torch.profiler;
the hand kernels are left out), the hand launches a call (every wrapper's
``launches`` count the tree has), and the host reads a call (the syncs
``torch.cuda.set_sync_debug_mode("warn")`` reports).

Each worker also times ``revo_keyframe_rows`` and ``revo_edge_cloud`` alone
at level 0 of frame 0 (the config's capacity and quad form) at B = 1 and
8: device ms a call (launches queued behind a spin kernel, CUDA events)
and ms a call through the wrapper (host-paced).

``--split`` adds, for OTHER (if given) and then THIS, a worker on a copy
of the tree whose ``csrc/frontend.cu`` this script rewrites with
``clock64`` stamps (``%globaltimer`` beside them) at the parts of the two
kernels; the copy exports ``revo_fe_stamps``, which reads them back.  The
stamps go in at lines this script knows in the two forms of frontend.cu
it was written for (``two_kernels``, a parent's: the edge cloud's count and
scatter kernels and the row-by-row keyframe kernel; ``cluster``: one
cluster a lane for the cloud, bands with DSMEM halos for the rows); another
form raises.  Parts, per block on its own clock (mean and slowest block,
us), and each kernel's span on the global timer (first block's start to
the last block's end; the gap between the cloud's two kernels in the first
form), at level 0 of frame 0, B = 1 and 8.

Usage (OTHER is an unpacked tree of another commit, e.g. ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 scripts/ab_front_end.py --other build/ab_parent [--split]
    python3 scripts/ab_front_end.py --split   # this tree alone, split
    python3 scripts/ab_front_end.py --check   # this tree's four kernels only

``--check`` holds this tree's front-end kernels (``edt_columns``,
``keyframe_rows``, ``backproject_edges``, ``pyr_level``) to their plain
versions, bit for bit, on a few shapes: a first call after editing
csrc/frontend.cu.  Prints one JSON object per worker and, as its last line,
the summary with the card's name and power limit.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import warnings

import numpy as np

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 8
KERNEL_LANES = (1, 8)  # B of the kernels timed alone and split
HOLD_CYCLES = 60_000_000  # chip_smoke.py's spin: ~30 ms while launches queue
# Wrappers whose ``launches`` count hand launches, by module; a tree counts
# those it has.
COUNTED = {
    "revo_tpu_torch.ops.canny": ("canny_fused", "canny_cluster", "canny_grid", "canny_nms",
                                 "canny_hysteresis"),
    "revo_tpu_torch.ops.edt": ("edt_columns", "keyframe_rows"),
    "revo_tpu_torch.ops.backproject": ("backproject_edges",),
    "revo_tpu_torch.ops.filters": ("pyr_level",),
}
HAND = ("canny_", "edt_columns_kernel", "keyframe_rows_kernel", "cloud_count_kernel",
        "cloud_scatter_kernel", "edge_cloud_kernel", "pyr_level_kernel")  # either tree's


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def render(path: str) -> None:
    """Frames 0-1 of the seeded chain (trajectory 0) at the default 640x480
    camera, uint8 gray and uint16 depth, into ``path``."""
    import multiprocessing as mp

    sys.path.insert(0, THIS)
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.io.synthetic import SyntheticScene, _render_one

    cfg = SystemConfig()
    scene = SyntheticScene()
    jobs = [(scene, cfg.camera, T, i) for i, T in enumerate(scene.trajectory(2, seed=0))]
    with mp.get_context("spawn").Pool(2) as pool:
        outs = pool.map(_render_one, jobs)
    scale = cfg.dataset.depth_scale_factor
    np.savez(path, grays=np.stack([g.astype(np.uint8) for g, _ in outs]),
             depths=np.stack([(d * scale).astype(np.uint16) for _, d in outs]))


def _counters():
    import importlib

    out = []
    for mod, names in COUNTED.items():
        m = importlib.import_module(mod)
        out += [getattr(m, n) for n in names if hasattr(m, n)]
    return out


def _hand_launches(fn) -> dict:
    import torch

    counters = _counters()
    for c in counters:
        c.launches = 0
    fn()
    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in counters if c.launches}


def _host_reads(fn) -> int:
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _torch_kernels(fn):
    """(device kernels torch launches, their device ms) of one call of
    ``fn``, by torch.profiler, hand kernels and copies left out; one warm-up
    call opens the window.  (-1, None) if the marked call is not in the
    trace."""
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
        return -1, None
    lo, hi = span[0]
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == on_card and lo <= e.time_range.start <= hi
          and e.name != "ab_marked" and not any(h in e.name for h in HAND)
          and not any(w in e.name.lower() for w in ("memcpy", "memset", "sync"))]
    return len(us), sum(us) / 1e3


def _ms(fn, reps: int = 10) -> float:
    import torch

    best = None
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        best = ms if best is None else min(best, ms)
    return best


def _queued_ms(fn, reps: int = 20):
    """Device ms a call of ``fn``, launches queued behind a spin kernel
    (chip_smoke.py's ``_queued_ms``); None if the host was still queueing
    when the spin ended."""
    import time

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


def _setup(root: str):
    """Import ``revo_tpu_torch`` from ``root`` and build its kernels."""
    sys.path.insert(0, root)
    import revo_tpu_torch
    from revo_tpu_torch import kernels

    if not revo_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {revo_tpu_torch.__file__}, not the tree at {root}")
    kernels.library()


def _level0_calls(frames_path: str) -> dict:
    """Per B of KERNEL_LANES: (keyframe_rows call, edge cloud call) on level 0
    of frame 0 in every lane, as ``make_keyframe`` and ``build_frame`` make
    them (the config's quad form and level-0 capacity)."""
    import torch

    from revo_tpu_torch import frontend
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.ops import backproject as BP
    from revo_tpu_torch.ops import edt as EDT

    data = np.load(frames_path)
    dev = torch.device("cuda")
    cfg = SystemConfig()
    pyr, form = cfg.pyramid, cfg.tracker.optimizer.quad_form
    cam = cfg.camera_pyramid()[0]
    lv = frontend.build_frame(torch.from_numpy(data["grays"][0]).to(dev),
                              torch.from_numpy(data["depths"][0]).to(dev), cfg).levels[0]
    out = {}
    for b in KERNEL_LANES:
        edges = lv.edges[None].expand(b, *lv.edges.shape).contiguous()
        depth = lv.depth[None].expand(b, *lv.depth.shape).contiguous()
        g2 = EDT.edt_columns(edges)
        out[b] = (lambda g2=g2: EDT.keyframe_rows(g2, form),
                  lambda e=edges, d=depth: BP.backproject_edges(
                      e, d, cam.fx, cam.fy, cam.cx, cam.cy, pyr.depth_min, pyr.depth_max,
                      pyr.edge_capacity[0]))
    return out


def worker(root: str, frames_path: str) -> dict:
    import torch

    _setup(root)
    from revo_tpu_torch import frontend
    from revo_tpu_torch.config import SystemConfig

    data = np.load(frames_path)
    dev = torch.device("cuda")
    cfg = SystemConfig()
    g, d = (torch.from_numpy(data[k][0]).to(dev) for k in ("grays", "depths"))
    g8, d8 = (torch.from_numpy(np.repeat(data[k][:2], LANES // 2, 0)).to(dev)
              for k in ("grays", "depths"))
    frame = frontend.build_frame(g, d, cfg)
    frame8 = frontend.build_frame_batched(g8, d8, cfg)
    eye, eye8 = torch.eye(4, device=dev), torch.eye(4, device=dev).repeat(LANES, 1, 1)
    calls = {
        "build_frame": lambda: frontend.build_frame(g, d, cfg),
        "make_keyframe": lambda: frontend.make_keyframe(frame, eye, cfg),
        "build_frame_b8": lambda: frontend.build_frame_batched(g8, d8, cfg),
        "make_keyframe_b8": lambda: frontend.make_keyframe_batched(frame8, eye8, cfg),
    }
    out = {"root": root}
    for name, fn in calls.items():
        n_torch, torch_ms = _torch_kernels(fn)
        out[name] = {"ms": _ms(fn), "torch_kernels": n_torch, "torch_device_ms": torch_ms,
                     "hand_launches": _hand_launches(fn), "host_reads": _host_reads(fn)}
    for b, (rows, cloud) in _level0_calls(frames_path).items():
        for name, fn in (("keyframe_rows", rows), ("edge_cloud", cloud)):
            out[f"{name}_level0_b{b}"] = {"device_ms": _queued_ms(fn), "ms": _ms(fn, 50)}
    return out


# -- the stamped copy of frontend.cu ---------------------------------------------

N_LANES, N_BLOCKS, N_MARKS = 8, 256, 10
_STAMP_HEAD = r"""
#include <cuda_runtime.h>
// kernel (0 the cloud's count, 1 the cloud, 2 the rows), lane, block, mark, (clock, ns)
__device__ long long g_fe_stamps[3][8][256][10][2];
#define FE_STAMP(kid, k)                                                     \
  do {                                                                       \
    if (threadIdx.x == 0 && blockIdx.y < 8 && blockIdx.x < 256) {            \
      long long ns_;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                \
      g_fe_stamps[kid][blockIdx.y][blockIdx.x][k][0] = clock64();            \
      g_fe_stamps[kid][blockIdx.y][blockIdx.x][k][1] = ns_;                  \
    }                                                                        \
  } while (0)
#define FE_CYCLES(kid, k, v)                                                 \
  do {                                                                       \
    if (threadIdx.x == 0 && blockIdx.y < 8 && blockIdx.x < 256)              \
      g_fe_stamps[kid][blockIdx.y][blockIdx.x][k][0] = (v);                  \
  } while (0)
"""

_STAMP_TAIL = r"""
extern "C" int revo_fe_stamps(void* out, int clear) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess && out) err = cudaMemcpyFromSymbol(out, g_fe_stamps, sizeof(g_fe_stamps));
  if (err == cudaSuccess && clear) {
    static long long zero[sizeof(g_fe_stamps) / sizeof(long long)];
    err = cudaMemcpyToSymbol(g_fe_stamps, zero, sizeof(g_fe_stamps));
  }
  return (int)err;
}
"""

# Per form: (anchor, what replaces it) edits, and per kernel id the marks:
# (name, mark a, mark b) parts timed on the block's clock, (name, mark) parts
# the block accumulated itself (cycles), and the mark of the block's end.
_FORMS = {
    "two_kernels": {
        "edits": [
            ("#include <stdint.h>\n", "#include <stdint.h>\n" + _STAMP_HEAD),
            # the rows: per row, its load with the barrier, then its search with the barrier
            ("  const float* lane_g2 = g2 + (size_t)b * H * W;\n",
             "  const float* lane_g2 = g2 + (size_t)b * H * W;\n  FE_STAMP(2, 0);\n"
             "  long long fe_load = 0, fe_search = 0, fe_t = 0;\n"),
            ("  for (int r = lo; r <= hi; ++r) {\n    bool finite = false;\n",
             "  for (int r = lo; r <= hi; ++r) {\n    bool finite = false;\n    fe_t = clock64();\n"),
            ("    const int any = __syncthreads_or(finite);\n",
             "    const int any = __syncthreads_or(finite);\n"
             "    fe_load += clock64() - fe_t;\n    fe_t = clock64();\n"),
            ("    __syncthreads();\n  }\n  auto dt = [&](int y, int x) {\n",
             "    __syncthreads();\n    fe_search += clock64() - fe_t;\n  }\n  FE_STAMP(2, 1);\n"
             "  auto dt = [&](int y, int x) {\n"),
            ("\n}\n\n// Shared memory of a band",
             "\n  __syncthreads();\n  FE_STAMP(2, 2);\n  FE_CYCLES(2, 8, fe_load);\n"
             "  FE_CYCLES(2, 9, fe_search);\n}\n\n// Shared memory of a band"),
            # the cloud's count kernel
            ("  const size_t lane = (size_t)blockIdx.y * n;\n",
             "  FE_STAMP(0, 0);\n  const size_t lane = (size_t)blockIdx.y * n;\n"),
            ("  if (threadIdx.x == 0) tile_counts[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = total;\n",
             "  if (threadIdx.x == 0) tile_counts[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = total;\n"
             "  FE_STAMP(0, 1);\n"),
            # the scatter kernel
            ("  const int* counts = tile_counts + (size_t)b * tiles;\n",
             "  FE_STAMP(1, 0);\n  const int* counts = tile_counts + (size_t)b * tiles;\n"),
            ("  const int count = block_sum(all, red);\n",
             "  const int count = block_sum(all, red);\n  FE_STAMP(1, 1);\n"),
            ("      zero_slot(pts, val, j);\n  // Exclusive scan of the threads' valid counts within the block.\n",
             "      zero_slot(pts, val, j);\n  __syncthreads();\n  FE_STAMP(1, 2);\n"
             "  // Exclusive scan of the threads' valid counts within the block.\n"),
            ("  for (int w = 0; w < wid; ++w) base += warp_sums[w];\n",
             "  for (int w = 0; w < wid; ++w) base += warp_sums[w];\n  FE_STAMP(1, 3);\n"),
            ("    ++pos;\n  }\n}\n", "    ++pos;\n  }\n  __syncthreads();\n  FE_STAMP(1, 4);\n}\n"),
        ],
        "parts": {
            0: [("count_kernel", 0, 1)],
            1: [("tile_count_sum", 0, 1), ("tail_zeros", 1, 2), ("loads_and_scan", 2, 3),
                ("winner_writes_and_gap_zeros", 3, 4)],
            2: [("rows_loop", 0, 1), ("table_stage", 1, 2)],
        },
        "cycles": {2: [("row_loads_and_barriers", 8), ("searches_and_barriers", 9)]},
        "end": {0: 1, 1: 4, 2: 2},
    },
    "cluster": {
        "edits": [
            ("#include <stdint.h>\n", "#include <stdint.h>\n" + _STAMP_HEAD),
            # the rows: one pass each of loads, search, halo, tables
            ("  // -- the rows' loads\n", "  FE_STAMP(2, 0);\n"),
            ("  // -- the rows' search\n", "  FE_STAMP(2, 1);\n"),
            ("  cluster.sync();  // every block's dt rows and slices are in its shared memory\n",
             "  __syncthreads();\n  FE_STAMP(2, 2);\n  cluster.sync();\n  FE_STAMP(2, 3);\n"),
            ("  cluster.sync();  // no block reads another's shared memory past here\n",
             "  cluster.sync();\n  FE_STAMP(2, 4);\n"),
            ("      }\n    }\n  }\n}\n\n// Shared memory of a band",
             "      }\n    }\n  }\n  __syncthreads();\n  FE_STAMP(2, 5);\n}\n\n"
             "// Shared memory of a band"),
            # the cloud
            ("    int* ws = sums + 32 * (round & 1);\n",
             "    FE_STAMP(1, 7);\n    int* ws = sums + 32 * (round & 1);\n"),
            ("  // -- the cloud's loads, bits, scan and list\n", "  FE_STAMP(1, 0);\n"),
            ("  // -- the cloud's cluster barrier\n", "  __syncthreads();\n  FE_STAMP(1, 1);\n"),
            ("  // -- the cloud's counts\n", "  FE_STAMP(1, 2);\n"),
            ("  if (k == 0 && threadIdx.x == 0) count_out[b] = count;\n",
             "  FE_STAMP(1, 3);\n  if (k == 0 && threadIdx.x == 0) count_out[b] = count;\n"),
            ("  // -- the cloud's tail\n", "  __syncthreads();\n  FE_STAMP(1, 4);\n"),
            ("    zero_slot(pts, val, j);\n}\n",
             "    zero_slot(pts, val, j);\n  __syncthreads();\n  FE_STAMP(1, 5);\n}\n"),
        ],
        "parts": {
            1: [("loads_bits_warp_scans", 0, 7), ("block_scan_and_list", 7, 1),
                ("cluster_barrier", 1, 2),
                ("counts", 2, 3), ("slot_writes", 3, 4), ("tail_zeros", 4, 5)],
            2: [("loads_and_barrier", 0, 1), ("search", 1, 2), ("cluster_barrier", 2, 3),
                ("halo_over_dsmem_and_barrier", 3, 4), ("table_stage", 4, 5)],
        },
        "cycles": {},
        "end": {1: 5, 2: 5},
    },
}


def stamped_copy(root: str, dest: str) -> str:
    """A copy of ``root``'s package in ``dest`` with the stamps in its
    frontend.cu; returns the form found."""
    shutil.copytree(os.path.join(root, "revo_tpu_torch"), os.path.join(dest, "revo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dest, "revo_tpu_torch", "csrc", "frontend.cu")
    src = open(path).read()
    for form, spec in _FORMS.items():
        if all(src.count(anchor) == 1 for anchor, _ in spec["edits"]):
            for anchor, repl in spec["edits"]:
                src = src.replace(anchor, repl)
            with open(path, "w") as f:
                f.write(src + _STAMP_TAIL)
            return form
    raise RuntimeError(f"{path}: not a form of frontend.cu this script knows")


def _summarise(buf: np.ndarray, kid: int, lanes: int, spec: dict) -> dict:
    """One launch's stamps of kernel ``kid``: per part the mean and the
    slowest block's us, the kernel's span on the global timer, its first
    start and last end (ns), and the SM clock's ns a cycle."""
    if kid not in spec["end"]:
        return {}
    st = buf[kid, :lanes]  # (lanes, blocks, marks, 2)
    last = spec["end"][kid]
    used = (st[:, :, 0, 1] > 0) & (st[:, :, last, 1] > 0)  # blocks with rows or pixels
    if not used.any():
        return {}
    blocks = st[used]  # (n, marks, 2)
    clk = blocks[:, :, 0].astype(np.float64)
    ns = blocks[:, :, 1].astype(np.float64)
    span_c, span_ns = clk[:, last] - clk[:, 0], ns[:, last] - ns[:, 0]
    long = span_c > 0
    ns_per_cycle = float(np.median(span_ns[long] / span_c[long])) if long.any() else float("nan")
    out = {"blocks": int(used.sum()), "ns_per_cycle": ns_per_cycle,
           "start_ns": float(ns[:, 0].min()), "end_ns": float(ns[:, last].max()),
           "span_us": float(ns[:, last].max() - ns[:, 0].min()) / 1e3, "parts_us": {}}
    for name, a, b in spec["parts"].get(kid, []):
        d = (clk[:, b] - clk[:, a]) * ns_per_cycle / 1e3
        out["parts_us"][name] = {"mean": float(d.mean()), "max": float(d.max())}
    for name, m in spec["cycles"].get(kid, []):
        d = clk[:, m] * ns_per_cycle / 1e3
        out["parts_us"][name] = {"mean": float(d.mean()), "max": float(d.max())}
    return out


def split_worker(root: str, frames_path: str, form: str) -> dict:
    """The stamped copy at ``root``: per kernel and B the parts, mean over
    ``reps`` launches of each statistic."""
    import ctypes

    import torch

    _setup(root)
    from revo_tpu_torch import kernels

    fn = kernels.library().lib.revo_fe_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    spec = _FORMS[form]
    buf = np.zeros((3, N_LANES, N_BLOCKS, N_MARKS, 2), np.int64)
    out = {"root": root, "form": form, "cases": []}
    reps = 20
    for b, (rows, cloud) in _level0_calls(frames_path).items():
        for name, call, kids in (("keyframe_rows", rows, (2,)), ("edge_cloud", cloud, (0, 1))):
            runs = []
            for _ in range(reps):
                if fn(None, 1) != 0:
                    raise RuntimeError("revo_fe_stamps failed")
                call()
                torch.cuda.synchronize()
                if fn(buf.ctypes.data, 0) != 0:
                    raise RuntimeError("revo_fe_stamps failed")
                runs.append({k: _summarise(buf, k, min(b, N_LANES), spec) for k in kids})
            case = {"kernel": name, "B": b, "launches": reps}
            for k in kids:
                got = [r[k] for r in runs if r[k]]
                if not got:
                    continue
                key = f"kernel_{k}"
                case[key] = {"blocks": got[0]["blocks"],
                             "span_us": float(np.mean([g["span_us"] for g in got])),
                             "ns_per_cycle": float(np.median([g["ns_per_cycle"] for g in got])),
                             "parts_us": {p: {s: float(np.mean([g["parts_us"][p][s] for g in got]))
                                              for s in ("mean", "max")}
                                          for p in got[0]["parts_us"]}}
            if all(r.get(0) and r.get(1) for r in runs):  # the gap between two kernels
                case["gap_between_kernels_us"] = float(np.mean(
                    [(r[1]["start_ns"] - r[0]["end_ns"]) / 1e3 for r in runs]))
            out["cases"].append(case)
    return out


def _bits(t):
    """``t``'s bits as integers: equal only where every bit is."""
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def check() -> dict:
    """This tree's four front-end kernels against their plain versions on
    the card, bit for bit; raises on the first difference."""
    sys.path.insert(0, THIS)
    import torch

    from revo_tpu_torch.ops import backproject as BP
    from revo_tpu_torch.ops import edt as EDT
    from revo_tpu_torch.ops import filters as FL

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = 0

    def same(a, b, what):
        nonlocal cases
        cases += 1
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(_bits(a), _bits(b)):
            raise RuntimeError(f"check: {what} differs from its plain version")

    for b, h, w in ((1, 480, 640), (3, 61, 79), (2, 37, 65), (1, 720, 1280)):
        edges = torch.rand((b, h, w), generator=gen) < 0.03
        edges[0] = False  # a lane with no edge
        if b > 1:
            edges[1] = True  # a lane of all edges
        e = edges.to(dev)
        g2 = EDT.edt_columns(e)
        same(g2, EDT.edt_columns_ref(e), f"edt_columns {b}x{h}x{w}")
        for form in EDT.QUAD_FORMS:
            s, q = EDT.keyframe_rows(g2, form)
            s_r, q_r = EDT.keyframe_rows_ref(g2, form)
            same(s, s_r, f"keyframe_rows structure {form} {b}x{h}x{w}")
            same(q, q_r, f"keyframe_rows quad {form} {b}x{h}x{w}")
        depth = torch.rand((b, h, w), generator=gen) * 6.0
        depth[:, ::7, ::3] = float("nan")
        depth[:, 1::11, ::5] = float("inf")
        depth[:, 2::13, ::2] = 0.0
        dd = depth.to(dev)
        n0 = int((edges & torch.isfinite(depth) & (depth > 0.1) & (depth < 5.2)).sum())
        for cap in (max(n0 // 3, 1), n0 + 5):
            got = BP.backproject_edges(e, dd, 525.0, 525.0, 319.5, 239.5, 0.1, 5.2, cap)
            want = BP.backproject_edges_ref(e, dd, 525.0, 525.0, 319.5, 239.5, 0.1, 5.2, cap)
            for x, y, f in zip(got, want, got._fields):
                same(x, y, f"edge cloud {f} cap {cap} {b}x{h}x{w}")
        gray = (torch.rand((b, h, w), generator=gen) * 255).round()
        raw = (depth.nan_to_num(0.0, 0.0, 0.0) * 5000).to(torch.int32).to(torch.uint16)
        for gi, di in ((gray.to(dev), dd), (gray.to(torch.uint8).to(dev), raw.to(dev))):
            for x, y, f in zip(FL.pyr_level(gi, di, 1.0 / 5000.0),
                               FL.pyr_level_ref(gi, di, 1.0 / 5000.0), ("gray", "depth")):
                same(x, y, f"pyr_level {f} {gi.dtype} {b}x{h}x{w}")
    torch.cuda.synchronize()
    return {"check_cases": cases}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--check", action="store_true", help="this tree's kernels only")
    ap.add_argument("--split", action="store_true", help="also split the two kernels into parts")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "FRAMES"), help=argparse.SUPPRESS)
    ap.add_argument("--split-worker", nargs=3, metavar=("ROOT", "FRAMES", "FORM"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(*args.worker)), flush=True)
        return 0
    if args.split_worker:
        print(json.dumps(split_worker(*args.split_worker)), flush=True)
        return 0
    if args.check:
        print(json.dumps(check()), flush=True)
        print(_smi())
        return 0
    roots = [os.path.abspath(args.other), THIS, THIS, os.path.abspath(args.other)] \
        if args.other else [THIS]
    os.makedirs(os.path.join(THIS, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(THIS, "build")) as tmp:
        frames = os.path.join(tmp, "frames.npz")
        render(frames)
        def run(*argv):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), *argv],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"worker {argv} failed:\n{proc.stdout}\n{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(res), flush=True)
            return res

        runs = [run("--worker", root, frames) for root in roots]
        if args.split:
            split_roots = [os.path.abspath(args.other), THIS] if args.other else [THIS]
            for k, root in enumerate(split_roots):
                copy = os.path.join(tmp, f"stamped_{k}")
                run("--split-worker", copy, frames, stamped_copy(root, copy))
    print(json.dumps({"smi": _smi(), "order": [r["root"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
