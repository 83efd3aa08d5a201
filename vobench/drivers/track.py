"""The tracking step alone, as a fleet of B lanes runs it: each step builds
the B lanes' frames (``frontend.build_frame_batched``), tracks them against
one keyframe (``tracker.track_frames_batched``) and reads the B poses and
errors back in one copy, as a serving loop hands them out.

Traffic (``vobench/traffic/<name>.json``): ``lanes`` B, ``frames`` N
rendered on a smooth seeded trajectory with ``step_mm`` and ``step_deg`` a
frame, ``chain`` C.  Frame 0 is every lane's keyframe, made at set-up.  Lane
b at step s takes frame (b + s) % N; the pose is carried from step to step
and every lane restarts from the identity every C steps, so a lane's chain
is decided by b % N alone.

``judge``: the reference works out every (chain start, position) pose from
the identity and compares every answer of the window with it; it also
compares the last step's B frames and the keyframe's tables.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from vobench import common, render
from vobench.reference import judge, vo

MAX_ERROR = 5.0  # a lane-frame whose error passes this has diverged (errors ~0.1)


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from revo_tpu_torch import frontend, kernels
        from revo_tpu_torch.lanes import add_lane_axis, lane

        clock = common.Clock(device)
        self.cell, self.seed, self.device = cell, seed, device
        tr, self.cfg = cell["traffic"], cell["config"]
        self.pc = common.port_config(self.cfg)
        self.lanes, self.n, self.chain = int(tr["lanes"]), int(tr["frames"]), int(tr["chain"])
        if device.type == "cuda":
            kernels.library()
        clock.mark("library")
        poses = render.trajectory(self.n, seed, tr["step_mm"] * 1e-3, np.deg2rad(tr["step_deg"]))
        self.gray, self.depth, _ = render.render(
            self.cfg["camera"], poses, self.cfg["dataset"]["depth_scale_factor"], device)
        clock.mark("render")
        b = self.lanes
        # The inputs of each step phase, stacked once: lane b takes frame (b + s) % N.
        self.inputs = [(torch.stack([self.gray[(i + s) % self.n] for i in range(b)]),
                        torch.stack([self.depth[(i + s) % self.n] for i in range(b)]))
                       for s in range(self.n)]
        kf1 = frontend.make_keyframe_batched(
            frontend.build_frame_batched(self.gray[:1], self.depth[:1], self.pc),
            torch.eye(4, device=device)[None], self.pc)
        clock.mark("inputs")
        self.kf_tables = [(s, q) for s, q in zip(kf1.structs, kf1.quads)]
        self.kf = add_lane_axis(lane(kf1, 0)._replace(frame=None), b)
        self.eye = (torch.eye(3, device=device).expand(b, 3, 3), torch.zeros(3, device=device).expand(b, 3))
        self.s, self.results, self.frame = 0, [], None
        self.R, self.t = self.eye
        self._events = []
        for _ in range(2 * self.chain):  # warm-up: two chains of every phase
            self.step()
        self.results = []
        clock.mark("warmup")
        self.setup_log = clock.log

    def step(self, traced: bool = False):
        """One step of the B lanes; the host holds its poses and errors."""
        from revo_tpu_torch import frontend, tracker

        if self.s % self.chain == 0:
            self.R, self.t = self.eye
        g, d = self.inputs[self.s % self.n]
        if not traced:
            frame = frontend.build_frame_batched(g, d, self.pc)
            res = tracker.track_frames_batched(self.kf, frame, self.R, self.t, self.pc)
            out = torch.cat([res.R.reshape(-1, 9), res.t, res.error[:, None]], 1).cpu()
        else:
            from torch.profiler import record_function

            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with record_function("build"):
                ev[0].record()
                frame = frontend.build_frame_batched(g, d, self.pc)
                ev[1].record()
            with record_function("track"):
                res = tracker.track_frames_batched(self.kf, frame, self.R, self.t, self.pc)
                ev[2].record()
            with record_function("read"):
                out = torch.cat([res.R.reshape(-1, 9), res.t, res.error[:, None]], 1).cpu()
            self._events.append(ev)
        self.R, self.t, self.frame = res.R, res.t, frame
        self.results.append((self.s, out.numpy()))
        self.s += 1

    def drop_last(self):
        self.results.pop()

    def launches(self) -> dict:
        return common.launches()

    def span_times(self) -> dict:
        """ms a step of the front end and of the solver on the device's
        timeline, from the traced segment's CUDA events."""
        if not self._events:
            return {}
        self._events[-1][-1].synchronize()
        return {"frontend_ms": [a.elapsed_time(b) for a, b, _ in self._events],
                "solver_ms": [b.elapsed_time(c) for _, b, c in self._events]}

    def window_promotions(self):
        return None

    def failed_in_window(self) -> int:
        bad = 0
        for _, out in self.results:
            ok = np.isfinite(out).all(axis=1) & (out[:, 12] <= MAX_ERROR)
            bad += int((~ok).sum())
        return bad

    def kernel_inputs(self) -> dict:
        """The last step's frames, as the per-layer readers time kernels on
        them."""
        lv = self.frame.levels
        return {"gray0": self.inputs[(self.s - 1) % self.n][0],
                "edges": [x.edges for x in lv]}

    def judge(self, limits: dict) -> dict:
        """Numbers of this run against the float64 reference."""
        prog = self.answers()
        self.release()
        return judge.checks(numbers(prog, expected(self.cell, self.seed, prog["spec"],
                                                   torch.float64, self.device)), limits)

    def answers(self) -> dict:
        """What the program produced that is judged: every pose of the
        window, the last step's frames and the keyframe's tables."""
        b, n = self.lanes, self.n
        steps = np.asarray([s for s, _ in self.results], dtype=np.int64)
        out = (np.stack([o for _, o in self.results]).reshape(-1, 13) if self.results
               else np.zeros((0, 13)))
        pos = np.repeat(steps % self.chain, b)
        start = (np.tile(np.arange(b), len(steps)) + np.repeat(steps, b) - pos) % n
        last_s = self.s - 1
        return dict(
            spec=dict(frames=[(i + last_s) % n for i in range(b)]),
            poses=np.stack([start, pos], 1), R=out[:, :9].reshape(-1, 3, 3), t=out[:, 9:12],
            frames=common.frame_levels(self.frame), tables=self.kf_tables)

    def release(self):
        self.inputs = self.kf = self.R = self.t = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def expected(cell: dict, seed: int, spec: dict, dt, device) -> dict:
    """The reference's answers in float type ``dt``: the pose of every
    (chain start frame, position), the frames ``spec["frames"]`` and frame
    0's keyframe tables."""
    tr, cfg = cell["traffic"], cell["config"]
    n, chain = int(tr["frames"]), int(tr["chain"])
    poses = render.trajectory(n, seed, tr["step_mm"] * 1e-3, np.deg2rad(tr["step_deg"]))
    gray, _, raw = render.render(cfg["camera"], poses, cfg["dataset"]["depth_scale_factor"], device)
    levels = vo.build(gray, raw, cfg, dt)
    tabs = vo.tables(common.pick(levels, [0]), cfg["optimizer"]["quad_form"], dt)
    kf = [(s.expand(n, *s.shape[1:]), q.expand(n, *q.shape[1:])) for s, q in tabs]
    R = torch.eye(3, dtype=dt, device=device).expand(n, 3, 3)
    t = torch.zeros((n, 3), dtype=dt, device=device)
    Rs, ts = [], []
    for j in range(chain):
        cur = common.pick(levels, [(ph + j) % n for ph in range(n)])
        R, t, *_ = vo.track(kf, cur, R, t, cfg, dt)
        Rs.append(R.double().cpu().numpy())
        ts.append(t.double().cpu().numpy())
    cams = vo.level_cams(cfg["camera"], len(levels))

    def cost(idx, R, t):
        """The objective at level 0 of answers (chain start, position) at
        poses (R, t), against frame 0's tables."""
        cur = common.pick(levels, [int((a + j) % n) for a, j in idx])[0]
        q = tabs[0][1].expand(len(idx), *tabs[0][1].shape[1:])
        return vo.cost(q, cur["points"], cur["valid"], cams[0],
                       torch.as_tensor(R, device=device), torch.as_tensor(t, device=device),
                       cfg["optimizer"], 0, dt)

    return dict(R=np.stack(Rs, 1), t=np.stack(ts, 1),  # (chain start, position, ...)
                frames=common.pick(levels, spec["frames"]), tables=tabs, cost=cost)


def numbers(prog: dict, exp: dict) -> dict:
    out = judge.frames_gap(prog["frames"], exp["frames"])
    out["kf_table"] = judge.tables_gap(prog["tables"], exp["tables"])
    if not len(prog["poses"]):
        return dict(out, cost_gap=0.0)
    _, c_prog, c_ref = costs(prog, exp)
    out["cost_gap"] = judge.cost_gap(c_prog, c_ref)
    return out


def costs(prog: dict, exp: dict):
    """Every distinct answer's (chain start, position), its objective,
    and the reference pose's objective at the same (chain start, position)."""
    idx = np.asarray(prog["poses"], dtype=np.int64).reshape(-1, 2)
    rows = np.concatenate([idx, prog["R"].reshape(-1, 9), prog["t"]], 1)
    uniq = np.unique(rows, axis=0)
    key = uniq[:, :2].astype(np.int64)
    return (key, exp["cost"](key, uniq[:, 2:11].reshape(-1, 3, 3), uniq[:, 11:14]),
            exp["cost"](key, exp["R"][key[:, 0], key[:, 1]], exp["t"][key[:, 0], key[:, 1]]))


def control_answers(ctl: dict, prog: dict) -> dict:
    """The control's answers in the program's form: its pose for each
    answer of the window."""
    idx = np.asarray(prog["poses"], dtype=np.int64).reshape(-1, 2)
    return dict(poses=idx, R=ctl["R"][idx[:, 0], idx[:, 1]], t=ctl["t"][idx[:, 0], idx[:, 1]],
                frames=ctl["frames"], tables=ctl["tables"])
