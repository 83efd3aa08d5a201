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

Each worker also times the front end's hand kernels alone on frame 0 in
every lane at B = 1 and 8 (``_front_calls``): ``revo_keyframe_rows`` and
``revo_edge_cloud`` at level 0 (the config's capacity and quad form), the
column pass and the pyramid in the form the tree has (a launch a level,
levels 0-2, and a launch a step, from level 0 and 1; or one launch for
every level, and one for both steps), the pyramid from uint8
gray with uint16 depth ("raw") and from float32: device ms a call
(launches queued behind a spin kernel, CUDA events) and ms a call through
the wrapper (host-paced).

``--split`` adds, for OTHER (if given) and then THIS, a worker on a copy
of the tree whose ``csrc/frontend.cu`` this script rewrites with
``clock64`` stamps (``%globaltimer`` beside them) at the parts of the four
kernels; the copy exports ``revo_fe_stamps``, which reads them back.  The
stamps go in at lines this script knows, for each kernel in each form of it
it knows (``_KERNEL_FORMS``); a kernel in another form raises.  Parts, per
block on its own clock (mean and slowest block, us; a part a barrier does
not close is thread 0's), and each launch's span on the global timer (first
block's start to the last block's end), for every call of ``_front_calls``.

Usage (OTHER is an unpacked tree of another commit, e.g. ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 scripts/ab_front_end.py --other build/ab_parent [--split]
    python3 scripts/ab_front_end.py --split   # this tree alone, split
    python3 scripts/ab_front_end.py --check   # this tree's four kernels only

``--check`` holds this tree's front-end kernels (``edt_columns_levels``,
``keyframe_rows``, ``backproject_edges``, ``pyramid``) to their plain
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
    "revo_tpu_torch.ops.edt": ("edt_columns", "edt_columns_levels", "keyframe_rows"),
    "revo_tpu_torch.ops.backproject": ("backproject_edges",),
    "revo_tpu_torch.ops.filters": ("pyr_level", "pyramid"),
}
HAND = ("canny_", "edt_columns_kernel", "edt_levels_kernel", "keyframe_rows_kernel",
        "edge_cloud_kernel", "pyr_level_kernel", "pyramid_kernel")  # either tree's


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


def _front_calls(frames_path: str) -> dict:
    """Name -> (B, kernel, call) of the front end's hand kernels on chain
    frame 0 in every lane, as ``make_keyframe`` and ``build_frame`` make
    them, at each B of KERNEL_LANES: ``keyframe_rows`` and the edge cloud
    at level 0 (the config's quad form and level-0 capacity); the column
    pass and the pyramid in the form the tree has (a launch a level, or one
    for every level), the pyramid from uint8 gray with uint16 depth
    ("raw") and from float32; in the form of a launch a step also the level-0 casts
    (kernel None: torch ops, not split)."""
    import torch

    from revo_tpu_torch import frontend
    from revo_tpu_torch.config import SystemConfig
    from revo_tpu_torch.ops import backproject as BP
    from revo_tpu_torch.ops import edt as EDT
    from revo_tpu_torch.ops import filters as FL

    data = np.load(frames_path)
    dev = torch.device("cuda")
    cfg = SystemConfig()
    pyr, form = cfg.pyramid, cfg.tracker.optimizer.quad_form
    cam = cfg.camera_pyramid()[0]
    inv = 1.0 / cfg.dataset.depth_scale_factor
    g_raw, d_raw = (torch.from_numpy(data[k][0]).to(dev) for k in ("grays", "depths"))
    lvs = frontend.build_frame(g_raw, d_raw, cfg).levels
    levels_form = hasattr(EDT, "edt_columns_levels")
    out = {}
    for b in KERNEL_LANES:
        def rep(x, b=b):
            return x[None].expand(b, *x.shape).contiguous()

        edges = [rep(lv.edges) for lv in lvs]
        if levels_form:
            g2 = EDT.edt_columns_levels(edges)[0]
            out[f"edt_columns_levels_b{b}"] = (b, "edt_columns",
                                               lambda e=edges: EDT.edt_columns_levels(e))
        else:
            g2 = EDT.edt_columns(edges[0])
            for lvl, e in enumerate(edges):
                out[f"edt_columns_level{lvl}_b{b}"] = (b, "edt_columns",
                                                       lambda e=e: EDT.edt_columns(e))
        out[f"keyframe_rows_level0_b{b}"] = (b, "keyframe_rows",
                                             lambda g2=g2: EDT.keyframe_rows(g2, form))
        out[f"edge_cloud_level0_b{b}"] = (b, "edge_cloud", lambda e=edges[0], d=rep(
            lvs[0].depth): BP.backproject_edges(e, d, cam.fx, cam.fy, cam.cx, cam.cy,
                                                pyr.depth_min, pyr.depth_max,
                                                pyr.edge_capacity[0]))
        inputs = {"raw": (rep(g_raw), rep(d_raw)), "float32": (rep(lvs[0].gray), rep(lvs[0].depth))}
        for kind, (g, d) in inputs.items():
            if hasattr(FL, "pyramid"):
                out[f"pyramid_{kind}_b{b}"] = (b, "pyramid", lambda g=g, d=d: FL.pyramid(
                    g, d, inv, pyr.n_levels))
            else:
                out[f"pyr_level0_{kind}_b{b}"] = (b, "pyramid",
                                                  lambda g=g, d=d: FL.pyr_level(g, d, inv))
        if not hasattr(FL, "pyramid"):
            out[f"pyr_level1_float32_b{b}"] = (b, "pyramid", lambda g=rep(lvs[1].gray), d=rep(
                lvs[1].depth): FL.pyr_level(g, d, inv))
            # the front end's level-0 casts, which the one-launch pyramid does itself
            out[f"level0_casts_b{b}"] = (b, None, lambda g=inputs["raw"][0], d=inputs["raw"][1]: (
                g.to(torch.float32), d.to(torch.float32) * inv))
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
    for name, (_, _, fn) in _front_calls(frames_path).items():
        out[name] = {"device_ms": _queued_ms(fn), "ms": _ms(fn, 50)}
    return out


# -- the stamped copy of frontend.cu ---------------------------------------------

N_KERNELS, N_BLOCKS, N_MARKS = 5, 4096, 10
_STAMP_HEAD = r"""
#include <cuda_runtime.h>
// kernel (1 the cloud, 2 the rows, 3 the column pass, 4 the pyramid), block
// (blockIdx.y * gridDim.x + blockIdx.x), mark, (clock, ns)
__device__ long long g_fe_stamps[5][4096][10][2];
#define FE_STAMP(kid, k)                                                     \
  do {                                                                       \
    const unsigned fe_b_ = blockIdx.y * gridDim.x + blockIdx.x;              \
    if (threadIdx.x == 0 && fe_b_ < 4096) {                                  \
      long long ns_;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                \
      g_fe_stamps[kid][fe_b_][k][0] = clock64();                             \
      g_fe_stamps[kid][fe_b_][k][1] = ns_;                                   \
    }                                                                        \
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

# Per kernel: its id in the stamp buffer and, per form of it in frontend.cu,
# the (anchor, what replaces it) edits, the parts timed on the block's clock
# (name, mark a, mark b) and the mark of the block's end.  A stamp is thread
# 0's: a part is its block's where a barrier closes it, else thread 0's own.
_KERNEL_FORMS = {
    "edge_cloud": (1, {
        "cluster": {  # one cluster a lane
            "edits": [
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
            "parts": [("loads_bits_warp_scans", 0, 7), ("block_scan_and_list", 7, 1),
                      ("cluster_barrier", 1, 2), ("counts", 2, 3), ("slot_writes", 3, 4),
                      ("tail_zeros", 4, 5)],
            "end": 5,
        }}),
    "keyframe_rows": (2, {
        "cluster": {  # bands in clusters, halo rows over DSMEM
            "edits": [
                ("  // -- the rows' loads\n", "  FE_STAMP(2, 0);\n"),
                ("  // -- the rows' search\n", "  FE_STAMP(2, 1);\n"),
                ("  cluster.sync();  // every block's dt rows and slices are in its shared memory\n",
                 "  __syncthreads();\n  FE_STAMP(2, 2);\n  cluster.sync();\n  FE_STAMP(2, 3);\n"),
                ("  cluster.sync();  // no block reads another's shared memory past here\n",
                 "  cluster.sync();\n  FE_STAMP(2, 4);\n"),
                ("      }\n    }\n  }\n}\n\n// Shared memory of a band",
                 "      }\n    }\n  }\n  __syncthreads();\n  FE_STAMP(2, 5);\n}\n\n"
                 "// Shared memory of a band"),
            ],
            "parts": [("loads_and_barrier", 0, 1), ("search", 1, 2), ("cluster_barrier", 2, 3),
                      ("halo_over_dsmem_and_barrier", 3, 4), ("table_stage", 4, 5)],
            "end": 5,
        }}),
    "edt_columns": (3, {
        "segments": {  # a block 32 columns x 8 segments, a launch a level
            "edits": [
                ("  const int cx = threadIdx.x % EDT_COLS, seg = threadIdx.x / EDT_COLS;\n",
                 "  FE_STAMP(3, 0);\n"
                 "  const int cx = threadIdx.x % EDT_COLS, seg = threadIdx.x / EDT_COLS;\n"),
                ("  __syncthreads();\n  if (x >= W) return;\n",
                 "  FE_STAMP(3, 1);\n  __syncthreads();\n  FE_STAMP(3, 2);\n  if (x >= W) return;\n"),
                ("  // Up: the nearest edge at or below; the smaller of the two, squared.\n",
                 "  FE_STAMP(3, 3);\n"),
                ("    out[(size_t)y * W] = v;\n  }\n}\n",
                 "    out[(size_t)y * W] = v;\n  }\n  FE_STAMP(3, 4);\n}\n"),
            ],
            "parts": [("segment_scan", 0, 1), ("barrier", 1, 2), ("down_sweep", 2, 3),
                      ("up_sweep", 3, 4)],
            "end": 4,
        },
        "levels": {  # every level in one launch, a cluster a strip of 64 columns
            "edits": [
                ("  // -- the columns' loads and chunk ends\n", "  FE_STAMP(3, 0);\n"),
                ("  // -- the columns' ends over DSMEM\n", "  __syncthreads();\n  FE_STAMP(3, 1);\n"),
                ("  // -- the columns' cluster barrier\n", "  __syncthreads();\n  FE_STAMP(3, 2);\n"),
                ("  // -- the columns' walks and stores\n", "  FE_STAMP(3, 3);\n"),
                ("  }  // the windows\n}\n", "  }\n  __syncthreads();\n  FE_STAMP(3, 4);\n}\n"),
            ],
            "parts": [("loads_and_chunk_ends", 0, 1), ("ends_over_dsmem", 1, 2),
                      ("cluster_barrier", 2, 3), ("walks_and_stores", 3, 4)],
            "end": 4,
        }}),
    "pyramid": (4, {
        "threads": {  # a thread an output pixel, a launch a step
            "edits": [
                ("  const int ho = (H + 1) / 2, wo = (W + 1) / 2, hd = H / 2, wd = W / 2;\n",
                 "  FE_STAMP(4, 0);\n"
                 "  const int ho = (H + 1) / 2, wo = (W + 1) / 2, hd = H / 2, wd = W / 2;\n"),
                ("  gray_out[((size_t)b * ho + i) * wo + j] = rintf(acc);\n",
                 "  gray_out[((size_t)b * ho + i) * wo + j] = rintf(acc);\n  FE_STAMP(4, 1);\n"),
                ("fmaxf(cnt, 1.0f)) : 0.0f;\n  }\n}\n",
                 "fmaxf(cnt, 1.0f)) : 0.0f;\n  }\n  FE_STAMP(4, 2);\n}\n"),
            ],
            "parts": [("gray_taps", 0, 1), ("depth_mean", 1, 2)],
            "end": 2,
        },
        "tiles": {  # two steps a launch, a block a tile of the second step's level
            "edits": [
                ("  // -- the pyramid's loads\n", "  FE_STAMP(4, 0);\n"),
                ("  // -- the pyramid's first step along x\n", "  FE_STAMP(4, 1);\n"),
                ("  // -- the pyramid's first step along y\n", "  FE_STAMP(4, 2);\n"),
                ("  if (!two) return;\n  __syncthreads();\n",
                 "  __syncthreads();\n  FE_STAMP(4, 3);\n  if (!two) return;\n"),
                ("d1s[r + 1][c + 1]);\n    }\n  }\n}\n",
                 "d1s[r + 1][c + 1]);\n    }\n  }\n  __syncthreads();\n  FE_STAMP(4, 4);\n}\n"),
            ],
            "parts": [("loads_and_depth", 0, 1), ("first_step_along_x", 1, 2),
                      ("first_step_along_y", 2, 3), ("second_step", 3, 4)],
            "end": 4,
        }}),
}


def stamped_copy(root: str, dest: str) -> dict:
    """A copy of ``root``'s package in ``dest`` with the stamps in its
    frontend.cu; returns each kernel's form found (raises where a kernel's
    code is in no form this script knows)."""
    shutil.copytree(os.path.join(root, "revo_tpu_torch"), os.path.join(dest, "revo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dest, "revo_tpu_torch", "csrc", "frontend.cu")
    src = open(path).read()
    found = {}
    for kernel, (_, forms) in _KERNEL_FORMS.items():
        for form, spec in forms.items():
            if all(src.count(anchor) == 1 for anchor, _ in spec["edits"]):
                for anchor, repl in spec["edits"]:
                    src = src.replace(anchor, repl)
                found[kernel] = form
                break
        else:
            raise RuntimeError(f"{path}: {kernel} is in no form this script knows")
    src = src.replace("#include <stdint.h>\n", "#include <stdint.h>\n" + _STAMP_HEAD, 1)
    with open(path, "w") as f:
        f.write(src + _STAMP_TAIL)
    return found


def _summarise(buf: np.ndarray, kid: int, spec: dict) -> dict:
    """One launch's stamps of kernel ``kid``: per part the mean and the
    slowest block's us, the kernel's span on the global timer, its first
    start and last end (ns), and the SM clock's ns a cycle."""
    st = buf[kid]  # (blocks, marks, 2)
    last = spec["end"]
    used = (st[:, 0, 1] > 0) & (st[:, last, 1] > 0)  # blocks whose thread 0 reached its end
    if not used.any():
        return {}
    blocks = st[used]  # (n, marks, 2)
    clk = blocks[:, :, 0].astype(np.float64)
    ns = blocks[:, :, 1].astype(np.float64)
    span_c, span_ns = clk[:, last] - clk[:, 0], ns[:, last] - ns[:, 0]
    long = span_c > 0
    ns_per_cycle = float(np.median(span_ns[long] / span_c[long])) if long.any() else float("nan")
    out = {"blocks": int(used.sum()), "ns_per_cycle": ns_per_cycle,
           "span_us": float(ns[:, last].max() - ns[:, 0].min()) / 1e3, "parts_us": {}}
    for name, a, b in spec["parts"]:
        d = (clk[:, b] - clk[:, a]) * ns_per_cycle / 1e3
        out["parts_us"][name] = {"mean": float(d.mean()), "max": float(d.max())}
    return out


def split_worker(root: str, frames_path: str, forms_json: str) -> dict:
    """The stamped copy at ``root``: per call of ``_front_calls`` its
    kernel's parts, mean over ``reps`` launches of each statistic."""
    import ctypes

    import torch

    _setup(root)
    from revo_tpu_torch import kernels

    fn = kernels.library().lib.revo_fe_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    forms = json.loads(forms_json)
    buf = np.zeros((N_KERNELS, N_BLOCKS, N_MARKS, 2), np.int64)
    out = {"root": root, "forms": forms, "cases": []}
    reps = 20
    for name, (b, kernel, call) in _front_calls(frames_path).items():
        if kernel is None:  # torch ops, no stamps
            continue
        kid, by_form = _KERNEL_FORMS[kernel]
        spec = by_form[forms[kernel]]
        runs = []
        for _ in range(reps):
            if fn(None, 1) != 0:
                raise RuntimeError("revo_fe_stamps failed")
            call()
            torch.cuda.synchronize()
            if fn(buf.ctypes.data, 0) != 0:
                raise RuntimeError("revo_fe_stamps failed")
            runs.append(_summarise(buf, kid, spec))
        got = [r for r in runs if r]
        case = {"call": name, "kernel": kernel, "form": forms[kernel], "B": b,
                "launches": reps}
        if got:
            case.update({"blocks": got[0]["blocks"],
                         "span_us": float(np.mean([g["span_us"] for g in got])),
                         "ns_per_cycle": float(np.median([g["ns_per_cycle"] for g in got])),
                         "parts_us": {p: {s: float(np.mean([g["parts_us"][p][s] for g in got]))
                                          for s in ("mean", "max")}
                                      for p in got[0]["parts_us"]}})
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
    cases, differ = 0, []

    def same(a, b, what):
        nonlocal cases
        cases += 1
        if a.dtype != b.dtype or a.shape != b.shape:
            differ.append(f"{what}: {a.dtype} {tuple(a.shape)} against {b.dtype} {tuple(b.shape)}")
        elif not torch.equal(_bits(a), _bits(b)):
            at = (_bits(a) != _bits(b)).nonzero()
            differ.append(f"{what}: {len(at)} differ, first at {at[:3].tolist()}: "
                          f"{[a[tuple(i)].item() for i in at[:3]]} against "
                          f"{[b[tuple(i)].item() for i in at[:3]]}")

    shapes = ((1, 480, 640), (3, 61, 79), (2, 37, 65), (1, 720, 1280))
    all_edges = []
    for b, h, w in shapes:
        edges = torch.rand((b, h, w), generator=gen) < 0.03
        edges[0] = False  # a lane with no edge
        if b > 1:
            edges[1] = True  # a lane of all edges
        e = edges.to(dev)
        all_edges.append(e)
        g2 = EDT.edt_columns_levels([e])[0]
        same(g2, EDT.edt_columns_ref(e), f"edt_columns_levels {b}x{h}x{w}")
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
        for gi, di in ((gray.to(dev), dd), (gray.to(torch.uint8).to(dev), raw.to(dev)),
                       (gray.to(dev), raw.to(dev))):
            for n in (2, 3, 4):
                for k, (x, y, z) in enumerate(zip(
                        FL.pyramid(gi, di, 1.0 / 5000.0, n),
                        FL.pyramid_ref(gi, di, 1.0 / 5000.0, n),
                        FL.pyramid_ref(gi.cpu(), di.cpu(), 1.0 / 5000.0, n))):
                    what = f"level {k} of {n} {gi.dtype} {di.dtype} {b}x{h}x{w}"
                    same(x[0], y[0], f"pyramid gray {what}")
                    same(x[1], y[1], f"pyramid depth {what}")
                    same(x[0].cpu(), z[0], f"pyramid gray (CPU plain) {what}")
                    same(x[1].cpu(), z[1], f"pyramid depth (CPU plain) {what}")
    # The column pass over levels of several shapes in one launch, and tall
    # lanes: 4320 rows (chunks of 540 rows, one window) and 20,000 rows
    # (chunks of 2,500 rows, three windows).
    tall = [torch.rand((1, 4320, 40), generator=gen) < 0.001,
            torch.rand((1, 20000, 24), generator=gen) < 0.0005]
    tall[1][0, :, 5] = False  # a column with no edge
    tall[1][0, 100, 7] = True  # a column with one edge
    tall[1][0, :, 9] = False
    tall[1][0, 19999, 9] = True
    for group in ([e for e in all_edges if e.shape[0] == 1], [e.to(dev) for e in tall]):
        for e, g2 in zip(group, EDT.edt_columns_levels(group)):
            same(g2, EDT.edt_columns_ref(e), f"edt_columns_levels {tuple(e.shape)} in a group")
    torch.cuda.synchronize()
    if differ:
        raise RuntimeError("check: differs from the plain versions:\n" + "\n".join(differ))
    return {"check_cases": cases}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--check", action="store_true", help="this tree's kernels only")
    ap.add_argument("--split", action="store_true", help="also split the two kernels into parts")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "FRAMES"), help=argparse.SUPPRESS)
    ap.add_argument("--split-worker", nargs=3, metavar=("ROOT", "FRAMES", "FORMS"),
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
                run("--split-worker", copy, frames, json.dumps(stamped_copy(root, copy)))
    print(json.dumps({"smi": _smi(), "order": [r["root"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
