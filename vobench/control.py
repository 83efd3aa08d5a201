"""Readings for the limits that decide ``correct``: the program's numbers
over many seeds, and the control's, the reference computed in bfloat16 (the
precision below the configuration's float32) and put in the program's
place, over the same answers.

    python -m vobench.control --workload NAME --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--witness-seeds 1 2 ...] [--seconds 3] [--device cuda]

For each seed: set-up and a short window at the cell's own load, as a run
makes them; the program's answers against the float64 reference; for the
control seeds also the bfloat16 reference's answers against it, and for the
witness seeds the float32 reference's (the program's own precision, an
implementation independent of it).  Beside each side's numbers, its three
answers whose objective lies furthest above the reference pose's.  One JSON
line a seed on standard output.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from vobench import driver_for, harness


def readings(cell: dict, seed: int, seconds: float, sides: dict, device) -> dict:
    mod = importlib.import_module(f"vobench.drivers.{cell['traffic']['driver']}")
    drv = driver_for(cell, seed, device)
    harness.run_window(drv, seconds)
    prog = drv.answers()
    drv.release()
    del drv
    gc.collect()
    exp = mod.expected(cell, seed, prog["spec"], torch.float64, device)
    out = {"seed": seed, "program": mod.numbers(prog, exp),
           "program_worst": worst(mod, prog, exp, prog["spec"])}
    if "flags" in prog:  # the scan: how many judged lane-steps the program flagged lost
        out["program_lost_judged"] = int(np.asarray(prog["flags"], bool).reshape(-1, 2)[:, 1].sum())
    for side, dt in (("control", torch.bfloat16), ("witness", torch.float32)):
        if seed in sides[side]:
            ans = mod.control_answers(mod.expected(cell, seed, prog["spec"], dt, device), prog)
            out[side] = mod.numbers(ans, exp)
            out[f"{side}_worst"] = worst(mod, ans, exp, prog["spec"])
    return out


def worst(mod, answers: dict, exp: dict, spec: dict, n: int = 3) -> list:
    """The ``n`` answers whose objective lies furthest above the reference
    pose's: the scan's (lane, step, frame, keyframe, previous frame), the
    track's (chain start, position), each with its excess in px^2."""
    if not len(answers.get("poses", answers.get("T_w", []))):
        return []
    which, c_prog, c_ref = mod.costs(answers, exp)
    excess = (c_prog.double() - c_ref.double()).cpu().numpy()
    out = []
    for m in np.argsort(-np.nan_to_num(excess, nan=np.inf))[:n]:
        w = which[m]
        if np.ndim(w):
            row = {"answer": [int(x) for x in w]}
        else:
            s = spec["samples"][int(w)]
            row = {k: s[k] for k in ("lane", "k", "cur", "kf", "prev")}
        out.append(dict(row, excess=float(excess[m])))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, Path.cwd())
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        sides = {"control": args.control_seeds, "witness": args.witness_seeds}
        print(json.dumps(readings(cell, seed, args.seconds, sides, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
