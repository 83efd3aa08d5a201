"""The whole VO system as a fleet runs it: B recorded sequences stepped
together, one call of ``parallel.batch._vo_scan_step_batched`` a step over
the B lanes' scan states, which ``parallel.batch._init_states`` makes at
set-up.  The step builds, tracks and votes for every lane, reads the lanes'
flags once, promotes and re-tracks the lanes that call for a keyframe, and
returns; the next step starts once the host holds the flags.

Traffic (``vobench/traffic/<name>.json``): ``lanes`` B, ``frames`` F
rendered on a seeded closed loop (``render.loop``) with ``step_mm`` and
``step_deg`` from each frame to the next, played in a cycle, so the motion
never reverses; lane b starts at frame round(b F / B), so promotions spread
over the steps.  ``warmup_steps`` steps run at set-up.

``judge``: the host mirrors each lane's scan state from the program's
outputs (poses and flags) as the scan carries it (keyframe, previous pose,
motion prior, the voting ring), and the reference works out a sample of
the window's lane-steps drawn from the seed (``samples`` spread evenly over
the lanes, each at a uniform step, up to ``promoted_samples`` among
promotions and up to ``lost_samples`` among lost lane-steps): the frame,
the keyframe's tables, the track from the carried start, the vote, the
jump gate, and the re-track against the previous frame that a promotion
gives; a pose is judged against the reference's on the keyframe the answer
took.  The last step's B frames and the B lanes' last keyframes are
compared too.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from vobench import common, render
from vobench.reference import judge, vo


def frame_at(k, traffic: dict) -> np.ndarray:
    """The frame shown at time ``k``: the loop played in a cycle."""
    return np.asarray(k) % int(traffic["frames"])


def frames_of(traffic: dict, seed: int) -> np.ndarray:
    """The rendered frames' poses: ``render.loop``."""
    return render.loop(int(traffic["frames"]), seed, traffic["step_mm"] * 1e-3,
                       np.deg2rad(traffic["step_deg"]))


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from revo_tpu_torch import frontend, kernels
        from revo_tpu_torch.parallel import batch

        clock = common.Clock(device)
        self.cell, self.seed, self.device = cell, seed, device
        tr, self.cfg = cell["traffic"], cell["config"]
        self.pc = common.port_config(self.cfg)
        self.lanes, self.frames = int(tr["lanes"]), int(tr["frames"])
        if device.type == "cuda":
            kernels.library()
        clock.mark("library")
        gray, depth, _ = render.render(self.cfg["camera"], frames_of(tr, seed),
                                       self.cfg["dataset"]["depth_scale_factor"], device)
        clock.mark("render")
        b, per = self.lanes, self.frames
        self.phase = np.round(np.arange(b) * per / b).astype(np.int64)
        # The B lanes' frames at each time k (mod F), stacked once.
        self.inputs = []
        for k in range(per):
            idx = frame_at(self.phase + k, tr)
            self.inputs.append((torch.stack([gray[i] for i in idx]),
                                torch.stack([depth[i] for i in idx])))
        del gray, depth
        clock.mark("inputs")
        self.states = batch._init_states(
            frontend.build_frame_batched(*self.inputs[0], self.pc), self.pc)
        clock.mark("init")
        self.k = 0
        self.T_w, self.flags, self.ks = [], [], []
        self._step = batch._vo_scan_step_batched
        for _ in range(int(tr["warmup_steps"])):
            self.step()
        self.window_from = len(self.ks)
        clock.mark("warmup")
        self.setup_log = clock.log

    def step(self, traced: bool = False):
        self.k += 1
        g, d = self.inputs[self.k % len(self.inputs)]
        if traced:
            from torch.profiler import record_function

            with record_function("scan_step"):
                self.states, out = self._step(self.states, g, d, self.pc)
        else:
            self.states, out = self._step(self.states, g, d, self.pc)
        self.T_w.append(out.T_w)
        self.flags.append(out.flags)
        self.ks.append(self.k)

    def drop_last(self):
        """The step that ended after the window: kept for the state mirror,
        left out of the window's counts."""
        self.window_to = len(self.ks) - 1

    def launches(self) -> dict:
        return common.launches()

    def span_times(self) -> dict:
        return {}

    def _window(self):
        return range(self.window_from, getattr(self, "window_to", len(self.ks)))

    def window_promotions(self):
        """(promotions, lane-frames) of the window."""
        w = self._window()
        return (sum(f[0] for i in w for f in self.flags[i]), len(w) * self.lanes)

    def failed_in_window(self) -> int:
        return sum(f[2] for i in self._window() for f in self.flags[i])

    def kernel_inputs(self) -> dict:
        """The B lanes' current frames and keyframes' edges, as the
        per-layer readers time kernels on them."""
        from revo_tpu_torch.lanes import stack_lanes

        prev = stack_lanes([s.prev for s in self.states])
        return {"gray0": self.inputs[self.k % len(self.inputs)][0],
                "edges": [lv.edges for lv in prev.levels]}

    def judge(self, limits: dict) -> dict:
        prog = self.answers()
        self.release()
        return judge.checks(numbers(prog, expected(self.cell, self.seed, prog["spec"],
                                                   torch.float64, self.device)), limits)

    def answers(self) -> dict:
        """What the program produced that is judged, and the spec the
        reference works from: the sampled lane-steps with the carried state
        mirrored from the outputs, the last frames and keyframes."""
        from revo_tpu_torch.lanes import stack_lanes

        b = self.lanes
        T_w = torch.stack(self.T_w).double().cpu().numpy()  # (steps, B, 4, 4)
        flags = np.asarray(self.flags, dtype=bool)  # (steps, B, 3)
        ks = np.asarray(self.ks)
        mirror = mirror_states(T_w, flags, ks, self.phase, self.cell["traffic"],
                               self.cfg["tracker"]["n_frames_histogram_voting"])
        rng = np.random.default_rng([self.seed, 1])
        tr = self.cell["traffic"]
        window = np.arange(self.window_from, getattr(self, "window_to", len(ks)))
        # Sample k takes lane k % B at a step drawn from the window, so every
        # lane is judged; up to ``promoted_samples`` more among promotions and
        # ``lost_samples`` among the lane-steps the scan flagged lost.
        lanes = np.arange(int(tr["samples"])) % b
        steps = rng.choice(window, size=len(lanes)) if len(window) else []
        promo = [(i, j) for i in window for j in range(b) if flags[i, j, 0]]
        pick_p = (rng.choice(len(promo), size=min(tr["promoted_samples"], len(promo)), replace=False)
                  if promo else [])
        lost = [(i, j) for i in window for j in range(b) if flags[i, j, 2]]
        pick_l = (rng.choice(len(lost), size=min(tr["lost_samples"], len(lost)), replace=False)
                  if lost else [])
        samples = sorted({(int(i), int(j)) for i, j in zip(steps, lanes)}
                         | {promo[p] for p in pick_p} | {lost[p] for p in pick_l})
        kfs = stack_lanes([s.kf._replace(frame=None) for s in self.states])
        prev = stack_lanes([s.prev for s in self.states])
        last = len(ks) - 1
        spec = dict(samples=[dict(mirror[i][j], lane=j, k=int(ks[i])) for i, j in samples],
                    frames=[int(x) for x in frame_at(self.phase + ks[last], tr)],
                    keyframes=[mirror[last + 1][j]["kf"] for j in range(b)])
        return dict(spec=spec,
                    T_w=np.stack([T_w[i, j] for i, j in samples]) if samples else np.zeros((0, 4, 4)),
                    flags=np.stack([flags[i, j, [0, 2]] for i, j in samples]) if samples
                    else np.zeros((0, 2), bool),
                    frames=common.frame_levels(prev),
                    tables=list(zip(kfs.structs, kfs.quads)))

    def release(self):
        self.inputs = self.states = self.T_w = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def mirror_states(T_w, flags, ks, phase, traffic: dict, k_vote: int):
    """Each lane's scan state before every step (and after the last), from
    the program's outputs alone: ``T_w`` (steps, B, 4, 4) world poses,
    ``flags`` (steps, B, 3) promoted / relocalized / lost, ``ks`` the steps'
    times.  A state is a dict of frame indices and float64 poses: the frame
    ``cur`` and ``prev``, the keyframe ``kf`` and its pose ``T_w_k``, the
    previous pose, the motion prior, the start (R0, t0) of the track, whether
    the last step promoted, and the voting set (frames and poses)."""
    n_steps, b = flags.shape[:2]
    eye = np.eye(4)
    f0 = frame_at(phase, traffic)
    lanes = []
    for j in range(b):
        st = dict(kf=int(f0[j]), T_w_k=eye, prev_T_w=eye, T_nm1_n=eye, T_init=eye,
                  just_added=True, past=[(int(f0[j]), eye)], voting=[(int(f0[j]), eye)],
                  prev=int(f0[j]))
        lanes.append(st)
    out = []
    for i in range(n_steps):
        row = []
        for j in range(b):
            st = lanes[j]
            cur = int(frame_at(phase[j] + ks[i], traffic))
            row.append(dict(st, cur=cur, R0=st["T_init"][:3, :3], t0=st["T_init"][:3, 3]))
            promoted, lost = bool(flags[i, j, 0]), bool(flags[i, j, 2])
            T = T_w[i, j]
            kf, T_w_k = st["kf"], st["T_w_k"]
            if promoted:
                kf, T_w_k = st["prev"], st["prev_T_w"]
            T_kf_n = np.linalg.inv(T_w_k) @ T
            T_nm1_n = np.linalg.inv(st["prev_T_w"]) @ T
            past, voting = st["past"], st["voting"]
            if not lost:
                if promoted:
                    voting = list(past)
                elif len(voting) < k_vote:
                    voting = voting + [(cur, T)]
                past = (past + [(cur, T)])[-k_vote:]
            lanes[j] = dict(kf=kf, T_w_k=T_w_k, prev_T_w=T, T_nm1_n=T_nm1_n,
                            T_init=st["T_init"] if lost else T_kf_n @ T_nm1_n,
                            just_added=promoted, past=past, voting=voting, prev=cur)
        out.append(row)
    out.append([dict(st) for st in lanes])
    return out


def expected(cell: dict, seed: int, spec: dict, dt, device) -> dict:
    """The reference's answers in float type ``dt`` for ``spec``: each
    sampled lane-step's world pose and (promoted, lost) flags worked out
    from its carried state, the frames ``spec["frames"]`` and the tables of
    the keyframes ``spec["keyframes"]``."""
    tr, cfg = cell["traffic"], cell["config"]
    trk = cfg["tracker"]
    gray, _, raw = render.render(cfg["camera"], frames_of(tr, seed),
                                 cfg["dataset"]["depth_scale_factor"], device)
    levels = vo.build(gray, raw, cfg, dt)
    form = cfg["optimizer"]["quad_form"]
    need = sorted({s["kf"] for s in spec["samples"]} | {s["prev"] for s in spec["samples"]}
                  | set(spec["keyframes"]))
    tabs = dict(zip(need, _split(vo.tables(common.pick(levels, need), form, dt))))
    out = dict(frames=common.pick(levels, spec["frames"]),
               tables=_stack_tables([tabs[i] for i in spec["keyframes"]]))
    samples = spec["samples"]
    if not samples:
        out.update(T_w=np.zeros((0, 4, 4)), flags=np.zeros((0, 2), bool), T_first=np.zeros((0, 4, 4)),
                   T_re=np.zeros((0, 4, 4)),
                   cost=lambda which, T, p: torch.zeros(0, dtype=torch.float64, device=device))
        return out

    def t64(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    n = len(samples)
    cur = common.pick(levels, [s["cur"] for s in samples])
    kft = _stack_tables([tabs[s["kf"]] for s in samples])
    R, t, *_ = vo.track(kft, cur, t64([s["R0"] for s in samples]).to(dt),
                        t64([s["t0"] for s in samples]).to(dt), cfg, dt)
    T_kf_n = _matrix(R.double(), t.double())
    T_w = t64([s["T_w_k"] for s in samples]) @ T_kf_n
    # The vote over each sample's voting set at the histogram level.
    hl = trk["histogram_level"]
    k = trk["n_frames_histogram_voting"]
    vf = [[f for f, _ in s["voting"]] + [s["cur"]] * (k - len(s["voting"])) for s in samples]
    vp = [[p for _, p in s["voting"]] + [np.eye(4)] * (k - len(s["voting"])) for s in samples]
    flat = common.pick(levels, [f for row in vf for f in row])[hl]
    pts = flat["points"].reshape(n, k, *flat["points"].shape[1:])
    val = flat["valid"].reshape(n, k, -1)
    new_kf = vo.vote(pts.to(dt), val, t64(vp).to(dt), torch.as_tensor([len(s["voting"]) for s in samples],
                                                                     device=device),
                     T_w.to(dt), cur[hl]["depth"], cur[hl]["edges_orig"], cfg)
    # The jump gate on the first track, as the scan takes it.
    d = torch.linalg.inv(t64([s["prev_T_w"] for s in samples])) @ T_w
    jump = ((torch.linalg.vector_norm(d[:, :3, 3], dim=-1) > trk["max_jump_translation"])
            | (vo.so3_angle(d[:, :3, :3]) > trk["max_jump_rotation"]))
    just = torch.as_tensor([s["just_added"] for s in samples], device=device)
    promote = new_kf & ~just & ~jump
    # Every sample's re-track against its previous frame from the motion
    # prior, whichever side promoted: the pose a promotion gives.
    prior = t64([s["T_nm1_n"] for s in samples])
    R2, t2, *_ = vo.track(_stack_tables([tabs[s["prev"]] for s in samples]), cur,
                          prior[:, :3, :3].to(dt), prior[:, :3, 3].to(dt), cfg, dt)
    T_re = t64([s["prev_T_w"] for s in samples]) @ _matrix(R2.double(), t2.double())
    lost = jump
    coast = t64([s["prev_T_w"] for s in samples]) @ prior
    T_first = T_w
    T_w = torch.where(lost[:, None, None], coast,
                      torch.where(promote[:, None, None], T_re, T_first))
    out.update(T_first=T_first.cpu().numpy(), T_re=T_re.cpu().numpy())
    out.update(T_w=T_w.cpu().numpy(),
               flags=torch.stack([promote, lost], 1).cpu().numpy())
    cam0 = vo.level_cams(cfg["camera"], len(levels))[0]

    def cost(which, T_w_given, promoted):
        """The objective at level 0 of samples ``which`` at world poses
        ``T_w_given``, each against the keyframe its ``promoted`` flag
        gives: the previous frame at the previous pose, else the carried
        keyframe."""
        if not len(which):
            return torch.zeros(0, dtype=torch.float64, device=device)
        sub = [samples[i] for i in which]
        kf_idx = [s["prev"] if p else s["kf"] for s, p in zip(sub, promoted)]
        T_w_k = t64([s["prev_T_w"] if p else s["T_w_k"] for s, p in zip(sub, promoted)])
        T = torch.linalg.inv(T_w_k) @ t64(T_w_given)
        q = torch.cat([tabs[i][0][1] for i in kf_idx])
        lv = common.pick(cur, list(which))[0]
        return vo.cost(q, lv["points"], lv["valid"], cam0, T[:, :3, :3], T[:, :3, 3],
                       cfg["optimizer"], 0, dt)

    out["cost"] = cost
    return out


def _matrix(R, t):
    T = torch.zeros((*R.shape[:-2], 4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3], T[..., :3, 3], T[..., 3, 3] = R, t, 1.0
    return T


def _split(tabs):
    """Batched per-level tables -> per lane a list of per-level tables."""
    n = tabs[0][0].shape[0]
    return [[(s[i:i + 1], q[i:i + 1]) for s, q in tabs] for i in range(n)]


def _stack_tables(per_lane):
    return [(torch.cat([lane[lvl][0] for lane in per_lane]),
             torch.cat([lane[lvl][1] for lane in per_lane])) for lvl in range(len(per_lane[0]))]


def numbers(prog: dict, exp: dict) -> dict:
    out = {}
    pf, ef = np.asarray(prog["flags"], bool).reshape(-1, 2), np.asarray(exp["flags"], bool).reshape(-1, 2)
    out["flags"] = float((pf != ef).any(1).sum())
    which, c_prog, c_ref = costs(prog, exp)
    out["cost_gap"] = judge.cost_gap(c_prog, c_ref)
    out["cost_share"] = judge.cost_share(c_prog, c_ref)
    out.update(judge.frames_gap(prog["frames"], exp["frames"]))
    out["kf_table"] = judge.tables_gap(prog["tables"], exp["tables"])
    return out


def costs(prog: dict, exp: dict):
    """The samples that neither side coasted, and the objective of each
    answer against the keyframe it took, beside the reference pose's on that
    keyframe."""
    pf, ef = np.asarray(prog["flags"], bool).reshape(-1, 2), np.asarray(exp["flags"], bool).reshape(-1, 2)
    which = np.nonzero(~pf[:, 1] & ~ef[:, 1])[0]
    promoted = pf[which, 0]
    T_ref = np.where(promoted[:, None, None], exp["T_re"][which], exp["T_first"][which])
    return (which, exp["cost"](which, prog["T_w"][which], promoted),
            exp["cost"](which, T_ref, promoted))


def control_answers(ctl: dict, prog: dict) -> dict:
    """The control's answers in the program's form (the same samples)."""
    return dict(T_w=ctl["T_w"], flags=ctl["flags"], frames=ctl["frames"], tables=ctl["tables"])
