"""The numbers behind tests/test_torch_soak.py's and
tests/test_torch_smoke_soak.py's tolerances, on the CPU at 160x120 (the
port's plain kernel versions, JAX jitted on the CPU), one JSON line per part:

    JAX_PLATFORMS=cpu python scripts/soak_parity.py [combined] [scan] [lengths] [vga_scenario]

- combined: TestSoakLight's 110-frame run in both packages: flags equal,
  the largest pose gaps over frames 0-29 and over the run (and its frame),
  the port's ATEs (~1.5 min);
- scan: the 160-frame scan soak in both packages: flags equal, the gaps
  over the first half and over the run (and its frame), the largest gap of
  a step from JAX's carried state over the second half (and its frame),
  both ATEs, promotions and relocalizations (~2 min);
- lengths: the port's scan soak at 120, 140, 150 and 160 frames (three
  circuits): promotions, relocalizations, ATE (~2 min);
- vga_scenario: chip_smoke.py phase 20 (a)'s 300-frame scenario at 160x120
  in both packages, metric float depth, and in the port from the uint16
  frames phase 20 feeds: final-graph ATE and relocalized frames (~5 min).
With no argument, all four.
"""
import json
import os
import pathlib
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import test_torch_soak as ts  # noqa: E402
from revo_tpu import system as jsystem  # noqa: E402
from revo_tpu_torch import system  # noqa: E402
from revo_tpu_torch.eval import absolute_trajectory_error  # noqa: E402
from revo_tpu_torch.io import synthetic as tsyn  # noqa: E402

torch.set_num_threads(1)


def _gaps(a, b):
    """Per-frame translation gaps (m) of two pose stacks."""
    return np.abs(a[:, :3, 3].astype(np.float64) - b[:, :3, 3].astype(np.float64)).max(axis=1)


def combined(cfgs):
    r = ts.run_combined(*cfgs)
    g = _gaps(r["est"], r["est_jax"])
    vo = r["vo"]
    return {
        "flags_equal": bool(np.array_equal(r["flags"], r["flags_jax"])),
        "relocalized_frames": np.nonzero(r["flags"][:, 1])[0].tolist(),
        "frames_0_29": ts.max_pose_gap(r["est"][:ts.EARLY_FRAMES], r["est_jax"][:ts.EARLY_FRAMES]),
        "whole_run": ts.max_pose_gap(r["est"], r["est_jax"]), "whole_run_frame": int(g.argmax()),
        "ate_live_m": absolute_trajectory_error(r["est"], r["gt"]).rmse,
        "ate_final_m": absolute_trajectory_error(
            np.stack([n.T_w_curr for n in vo.pose_graph]), r["gt"]).rmse,
        "keyframes": vo.n_keyframes, "relocalized": vo.n_relocalized}


def scan(cfgs):
    with tempfile.TemporaryDirectory() as tmp:
        r = ts.run_scan(*ts.scan_cfgs(cfgs[0]), pathlib.Path(tmp))
    half = ts.CKPT_AT + 1
    g = _gaps(r["poses"], r["poses_jax"])
    steps = [ts.max_pose_gap(a[None].astype(np.float64), b[None].astype(np.float64))
             for a, b, _, _ in r["steps"]]
    worst = int(np.argmax([s[0] for s in steps]))
    return {
        "flags_equal": bool(np.array_equal(r["flags"], r["flags_jax"])),
        "first_half": ts.max_pose_gap(r["poses"][:half].astype(np.float64),
                                      r["poses_jax"][:half].astype(np.float64)),
        "whole_run_m": float(g.max()), "whole_run_frame": int(g.argmax()),
        "around_it_m": g[max(g.argmax() - 1, 0):g.argmax() + 2].tolist(),
        "step_worst": steps[worst], "step_worst_frame": half + worst,
        "step_others_m": max(s[0] for i, s in enumerate(steps) if i != worst),
        "resume_bit_equal": bool(np.array_equal(r["resumed"], r["poses"][half:])),
        "ate_m": absolute_trajectory_error(r["poses"].astype(np.float64), r["gt"]).rmse,
        "ate_jax_m": absolute_trajectory_error(r["poses_jax"].astype(np.float64), r["gt"]).rmse,
        "promoted": int(r["flags"][:, 0].sum()), "relocalized": int(r["flags"][:, 1].sum())}


def lengths(cfgs):
    _, tcfg = ts.scan_cfgs(cfgs[0])
    out = {}
    for n in (120, 140, 150, 160):
        g_all, d_all, traj = ts.render_scan(cfgs[0], n)
        poses, flags = ts.run_scan_port(tcfg, g_all, d_all)
        out[n] = {"promoted": int(flags[:, 0].sum()), "relocalized": int(flags[:, 1].sum()),
                  "ate_m": absolute_trajectory_error(poses.astype(np.float64), traj).rmse}
    return out


def vga_scenario(cfgs):
    """Phase 20 (a)'s order, drift window and gates' inputs at 160x120."""
    cfg, tcfg = cfgs
    traj = tsyn.loop_trajectory(cs.SOAK_FRAMES, radius=cs.SOAK_RADIUS, wobble=0.004,
                                seed=cs.SOAK_SEED, circuits=cs.SOAK_CIRCUITS)
    rendered = list(tsyn.render_trajectory(tsyn.box_scene(), cfg.camera, traj, seed=cs.SOAK_SEED))
    order = list(range(cs.SOAK_TELEPORT_FROM)) + list(
        range(cs.SOAK_TELEPORT_TO, cs.SOAK_TELEPORT_TO + cs.SOAK_REPLAY))
    out = {}
    for name, vo, sensor in (("jax_float", jsystem.VOSystem(cfg), False),
                             ("port_float", system.VOSystem(tcfg, device="cpu"), False),
                             ("port_uint16", system.VOSystem(tcfg, device="cpu"), True)):
        relocs = []
        for k, i in enumerate(order):
            gray, depth, _, _ = rendered[i]
            scale = (cs.SOAK_DRIFT_SCALE if k < cs.SOAK_TELEPORT_FROM
                     and cs.SOAK_DRIFT[0] <= i < cs.SOAK_DRIFT[1] else 1.0)
            if sensor:  # as phase 20 feeds them
                gray = gray.astype(np.uint8)
                raw = (depth * cfg.dataset.depth_scale_factor).astype(np.uint16)
                depth = np.round(raw * scale).astype(np.uint16) if scale != 1.0 else raw
            else:
                depth = depth * scale
            before = vo.n_relocalized
            vo.process_frame(gray, depth, k / 30.0)
            if vo.n_relocalized > before:
                relocs.append(k)
        out[name] = {"ate_final_m": absolute_trajectory_error(
            np.stack([n.T_w_curr for n in vo.pose_graph]), traj[order]).rmse,
            "keyframes": vo.n_keyframes, "relocalized_frames": relocs}
    return out


def main() -> int:
    parts = {"combined": combined, "scan": scan, "lengths": lengths, "vga_scenario": vga_scenario}
    cfg = ts._soak_cfg(ts.small_cfg())
    cfgs = (cfg, ts.convert.config_from_jax(cfg))
    for name in sys.argv[1:] or list(parts):
        print(json.dumps({name: parts[name](cfgs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
