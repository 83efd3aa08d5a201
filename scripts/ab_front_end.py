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

Usage (OTHER is an unpacked tree of another commit, e.g. ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 scripts/ab_front_end.py --other build/ab_parent
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
import subprocess
import sys
import tempfile
import warnings

import numpy as np

THIS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 8
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
        "cloud_scatter_kernel", "pyr_level_kernel")


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


def worker(root: str, frames_path: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import revo_tpu_torch
    from revo_tpu_torch import frontend, kernels
    from revo_tpu_torch.config import SystemConfig

    if not revo_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {revo_tpu_torch.__file__}, not the tree at {root}")
    kernels.library()
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
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "FRAMES"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(*args.worker)), flush=True)
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
        runs = []
        for root in roots:
            proc = subprocess.run([sys.executable, __file__, "--worker", root, frames],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"worker {root} failed:\n{proc.stdout}\n{proc.stderr}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"smi": _smi(), "order": [r["root"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
