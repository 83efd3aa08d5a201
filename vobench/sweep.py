"""The lane sweep that fixes a traffic mix's B: one run of a cell for each
B, each in a process of its own, traced, with B set in place of the
traffic file's ``lanes``.

    python -m vobench.sweep --workload NAME --lanes 8 32 64 128 [--seconds 5] [--seed N ...]
        [--trace 0|1]

Prints each run's result line with ``lanes`` and ``seed`` added.  The benchmark's runs never run this; the traffic
file keeps what it chose.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def one(workload: str, lanes: int, seed: int, seconds: float, trace: bool) -> dict:
    from vobench import harness

    cell = harness.load_cell(workload, Path.cwd())
    cell["traffic"] = dict(cell["traffic"], lanes=lanes)
    line = harness.run_cell(cell, seed, seconds, trace, torch.device("cuda", 0))
    return dict(lanes=lanes, seed=seed, **line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vobench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--lanes", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, nargs="+", default=[20261018])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.workload, args.lanes[0], args.seed[0], args.seconds,
                             bool(args.trace))), flush=True)
        return 0
    for b in args.lanes:
        for seed in args.seed:
            proc = subprocess.run([sys.executable, "-m", "vobench.sweep", "--one", "--workload",
                                   args.workload, "--lanes", str(b), "--seconds", str(args.seconds),
                                   "--seed", str(seed), "--trace", str(args.trace)],
                                  capture_output=True, text=True)
            last = proc.stdout.strip().splitlines()[-1:] or [""]
            print(last[0] if proc.returncode == 0 else json.dumps(
                {"lanes": b, "seed": seed, "rc": proc.returncode, "stderr": proc.stderr[-2000:]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
