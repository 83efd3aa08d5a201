"""The benchmark's frame: find a cell's files by name, run its driver's
set-up, window, traced segment and judgement, and print the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files are
found by name: ``configs`` gives the configuration's file, the traffic mix is
``vobench/traffic/<traffic>.json`` and names its driver
(``vobench/drivers/<driver>.py``), the limits of the numbers that decide
``correct`` are ``vobench/limits/<workload>.json``, and each per-layer metric
is read by ``vobench/layer_metrics/<metric>.py``.

A run: set-up (imports, the card, the kernel library, rendering, the
driver's state and warm-up) ends when the window starts; ``setup_s`` is the
process's age then.  The window runs whole steps for ``--seconds`` by the
host's clock; a step that ends after the window's end is not counted.  With
``--trace 1`` the window is followed by a traced segment (torch.profiler,
the harness's spans) and the per-layer readers, so the window itself runs
as in an untraced run.  Then the peak device memory is read,
the program's state is dropped, and the plain reference judges what the
program produced.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "revo_tpu")
TRACE_SECONDS = 2.0  # length of the traced segment that follows the window


def process_age() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path) -> dict:
    """The workload entry of ``root/BENCHMARK.json`` with its configuration,
    traffic, limits and per-layer metrics, each found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits_file = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_file) if limits_file.exists() else {}
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return dict(name=workload, workload=w, config=config, traffic=traffic, limits=limits,
                end_to_end=end_to_end, per_layer=per_layer, run_seconds=bench["run_seconds"])


def reader(metric: str):
    """The per-layer metric's reader module, ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_layer_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linear between order statistics
    (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class GcClock:
    """Seconds the host spent in Python's garbage collector, and the
    collections of each generation, while open."""

    def __enter__(self):
        self.seconds, self.runs, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._tick)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)

    def _tick(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.runs[info["generation"]] += 1


def card_info(device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit"] = out
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = None
    return info


def run_window(driver, seconds: float):
    """Whole steps for ``seconds`` by the host's clock: returns (the steps'
    durations, the window's start by ``perf_counter``).  The step that ends
    after the window's end is run but not counted."""
    durations = []
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        driver.step()
        t1 = time.perf_counter()
        if t1 > deadline:
            driver.drop_last()
            break
        durations.append(t1 - t0)
    return durations, start


def trace_segment(driver, seconds: float) -> dict:
    """Steps for ``seconds`` under torch.profiler (CPU and CUDA activity),
    each inside the driver's spans; returns the trace's complete events as
    (name, category, start ns, duration ns), the segment's step count, and
    the seconds the host spent in the garbage collector while tracing.
    The trace goes through a Chrome trace file in the temporary directory,
    deleted once read."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    launches0 = driver.launches()
    steps = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with GcClock() as gc_clock, record_function("window"):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds or steps == 0:
                driver.step(traced=True)
                steps += 1
        torch.cuda.synchronize()
    launches = {k: v - launches0[k] for k, v in driver.launches().items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    events = [(e.get("name", ""), e.get("cat", ""), int(float(e["ts"]) * 1000),
               int(float(e.get("dur", 0)) * 1000))
              for e in raw.get("traceEvents", []) if e.get("ph") == "X" and "ts" in e]
    return dict(events=events, steps=steps, launches=launches, gc_s=gc_clock.seconds,
                gc_runs=gc_clock.runs)


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("build", "track", "read", "scan_step")


def summarise_trace(trace: dict, hand_names) -> dict:
    """From the traced segment's events: the window (its "window" span),
    busy seconds (union of device operations), the torch kernels (device
    kernels that are not hand kernels), host reads (device-to-host copies and
    synchronise calls), the ten costliest device operations and the ten
    longest idle gaps, each named by the harness span the host was in."""
    ev = trace["events"]
    window = [(s, s + d) for n, k, s, d in ev if n == "window" and k == "user_annotation"]
    w0, w1 = window[0] if window else (min(s for _, _, s, _ in ev), max(s + d for _, _, s, d in ev))
    dev_ops = [(n, k, s, s + d) for n, k, s, d in ev if k in DEVICE_KINDS and s + d > w0 and s < w1]
    busy_ns = _union([(max(s, w0), min(e, w1)) for _, _, s, e in dev_ops])
    by_name = {}
    for n, _, s, e in dev_ops:
        t, c = by_name.get(n, (0, 0))
        by_name[n] = (t + (e - s), c + 1)
    torch_kernels = sum(1 for n, k, _, _ in dev_ops
                        if k == "kernel" and not any(h in n for h in hand_names))
    syncs = sum(1 for n, k, s, _ in ev if k in ("cuda_runtime", "cuda_driver")
                and "Synchronize" in n and w0 <= s < w1)
    d2h = sum(1 for n, k, _, _ in dev_ops if k == "gpu_memcpy" and "DtoH" in n)
    spans = sorted((s, s + d, n) for n, k, s, d in ev if k == "user_annotation" and n in SPANS)
    gaps, end = [], w0
    for _, _, s, e in sorted(dev_ops, key=lambda x: x[2]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        host = "other"
        for s0, s1, n in spans:
            if s0 <= g0 < s1:
                host = n
        named.append([host, (g1 - g0) * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, steps=trace["steps"],
                torch_kernels=torch_kernels, syncs=syncs, d2h=d2h, launches=trace["launches"],
                device_ops=[[n, t * 1e-9, c] for n, (t, c) in top], idle_gaps=named,
                hand_seen={n: c for n, (_, c) in by_name.items()
                           if any(h in n for h in hand_names)})


def hand_kernel_names():
    """The device functions of the program's csrc/*.cu, by the names the
    profiler gives them."""
    import re

    import revo_tpu_torch

    names = set()
    for src in (Path(revo_tpu_torch.__file__).parent / "csrc").glob("*.cu*"):
        text = src.read_text()
        for m in re.finditer(r"__global__[^(]*?\b(\w+)\s*\(", text):
            names.add(m.group(1))
    return sorted(names)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m vobench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(args.workload, root)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vobench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"vobench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell``: the result line's fields, ``checks`` last."""
    from vobench import common, driver_for

    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    drv = driver_for(cell, seed, device)
    _sync(device)
    setup_s = process_age()
    with GcClock() as gc_clock:
        durations, _ = run_window(drv, seconds)
    if durations:
        ms = 1e3 * np.asarray(durations)
        print(f"window: steps {len(ms)}, step ms p50 {np.median(ms):.3f} p95 "
              f"{percentile(ms, 95):.3f} max {ms.max():.3f}, over 100 ms {int((ms > 100).sum())}; "
              f"gc {gc_clock.seconds:.3f} s in {gc_clock.runs} collections", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    lanes = drv.lanes
    steps = len(durations)
    metrics = {}
    wanted = {m["name"]: m for m in cell["end_to_end"]}
    if "lane_frames_per_s" in wanted:
        metrics["lane_frames_per_s"] = {"value": steps * lanes / seconds, "unit": "frames/s"}
    if "step_ms_p95" in wanted and durations:
        metrics["step_ms_p95"] = {"value": 1e3 * percentile(durations, 95), "unit": "ms"}
    if "setup_s" in wanted:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        obs = dict(lanes=lanes, durations=durations, config=cell["config"],
                   driver=drv, device=device, promoted=drv.window_promotions(),
                   window_steps=steps)
        if device.type == "cuda":
            t = trace_segment(drv, TRACE_SECONDS)
            print(f"traced segment: gc {t['gc_s']:.3f} s in {t['gc_runs']} collections",
                  file=sys.stderr)
            obs["trace"] = summarise_trace(t, hand_kernel_names())
            obs["spans"] = drv.span_times()
            dev_info.update(busy_s=obs["trace"]["busy_s"], window_s=obs["trace"]["window_s"])
            breakdown = {
                "device_ops": [[f"{_short(n)} x{c} (wrapper launches: "
                                f"{common.wrapper_launches(n, obs['trace']['launches'])})", s]
                               for n, s, c in obs["trace"]["device_ops"]],
                "idle_gaps": obs["trace"]["idle_gaps"]}
        metrics.update(read_layers(cell, obs))
        dev_info.update(card_info(device) if device.type == "cuda" else {})
    attempted, failed = steps * lanes, drv.failed_in_window()
    print(f"setup: {json.dumps(drv.setup_log)}", file=sys.stderr)
    t_judge = time.perf_counter()
    checks = drv.judge(cell["limits"])
    print(f"judge_s: {time.perf_counter() - t_judge:.3f}", file=sys.stderr)
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # A window with no completed step judged nothing.
    correct = steps > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": bool(correct) and failed == 0, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def _short(name: str, width: int = 160) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width] + "..."


def read_layers(cell: dict, obs: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in cell["per_layer"]:
        mod = reader(m["name"])
        value = mod.read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
