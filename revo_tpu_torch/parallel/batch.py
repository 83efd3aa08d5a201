"""Whole-sequence VO as a device loop, and multi-sequence batching
(counterpart of revo_tpu/parallel/batch.py).

The frame loop of system.py (tracking, histogram-voting promotion and
re-track, motion prior, jump gate and, with
``TrackerConfig.scan_relocalization``, ring relocalization) over a
preloaded (N, H, W) sequence whose frames stay on their device.  JAX runs it
as one ``lax.scan``; here it is a Python loop whose ``lax.cond``s are ``if``s
on flags read once per frame.  The semantics are the scan's own, which
differ from the host loop's in three places:

- without ``scan_relocalization`` a jump coasts on the motion prior;
- a lost frame never promotes;
- the voting set follows the scan's merge: on promotion it freezes to the
  rolling ring before the current frame, and before the first promotion it
  fills with the first K frames.

B sequences step together (``vo_scan_batched``, JAX's ``vmap`` of the
scan): each frame is one batched build, track and vote over all lanes
(``system.frame_step_batched``), the lanes' flags come back in one (B, 4)
read, and relocalization, promotion and the re-track run as one batch over
the lanes that take them.  Every lane carries its own ScanVOState (what
``checkpoint.save_scan_state`` writes) and gets the bits it gets alone;
``vo_scan`` is the B = 1 case.

The 4x4 algebra rounds as jitted XLA on the CPU does (``lie.matmul_fma``,
``lie.inv_lu``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from revo_tpu_torch import lie, tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import (
    Frame, Keyframe, build_frame, build_frame_batched, make_keyframe_batched,
)
from revo_tpu_torch.lanes import add_lane_axis, lane, stack_lanes
from revo_tpu_torch.parallel.mesh import gather, shard
from revo_tpu_torch.system import frame_step_batched
from revo_tpu_torch.tracker import KeyframeRing, PastFrames


class ScanVOState(NamedTuple):
    kf: Keyframe  # current keyframe (structs + embedded frame + T_w_k)
    prev: Frame  # previous frame (promotion candidate)
    prev_T_w: torch.Tensor  # (4, 4) previous frame's world pose
    past: PastFrames  # rolling ring: newest K frames
    past_voting: PastFrames  # frozen voting set (tracker.PastFrames)
    R: torch.Tensor  # (3, 3) init guess T_kf_curr
    t: torch.Tensor  # (3,)
    T_nm1_n: torch.Tensor  # (4, 4) frame-to-frame motion prior
    just_added_kf: bool
    n_keyframes: int
    # Recent-keyframe ring for relocalization (None unless
    # cfg.tracker.scan_relocalization).
    kf_ring: Optional[KeyframeRing] = None


class ScanVOOutput(NamedTuple):
    T_w: torch.Tensor  # (4, 4) per-frame world pose
    error: torch.Tensor  # () tracking error
    good: torch.Tensor  # () int32
    promoted: torch.Tensor  # () bool: this frame triggered a promotion
    relocalized: torch.Tensor  # () bool: ring relocalization re-anchored it
    lost: torch.Tensor  # () bool: the frame coasted on the motion prior


def _init_states(frame0: Frame, cfg: SystemConfig) -> List[ScanVOState]:
    """The scan states of B sequences from their batched first frames."""
    dev = frame0.levels[0].gray.device
    b = frame0.levels[0].gray.shape[0]
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    kfs = make_keyframe_batched(frame0, eye4.expand(b, 4, 4), cfg)
    lvl = cfg.tracker.histogram_level
    states = []
    for i in range(b):
        kf, f0 = lane(kfs, i), lane(frame0, i)
        kf = kf._replace(frame=f0)
        past = tracker.empty_past(
            cfg.tracker.n_frames_histogram_voting, cfg.pyramid.edge_capacity[lvl], dev
        )
        cl = f0.levels[lvl].cloud
        past = tracker.push_past(past, cl.points, cl.valid, eye4)
        ring = (
            tracker.ring_from_keyframe(kf, cfg.tracker.kf_history_size)
            if cfg.tracker.scan_relocalization
            else None
        )
        states.append(ScanVOState(
            kf=kf, prev=f0, prev_T_w=eye4, past=past, past_voting=past,
            R=torch.eye(3, device=dev), t=torch.zeros(3, device=dev), T_nm1_n=eye4,
            just_added_kf=True, n_keyframes=1, kf_ring=ring,
        ))
    return states


def _init_state(frame0: Frame, cfg: SystemConfig) -> ScanVOState:
    return _init_states(add_lane_axis(frame0), cfg)[0]


class _StepOut(NamedTuple):
    """One frame of B lanes: tensors with the lane axis, flags on the host."""

    T_w: torch.Tensor  # (B, 4, 4)
    error: torch.Tensor  # (B,)
    good: torch.Tensor  # (B,) int32
    flags: List[Tuple[bool, bool, bool]]  # per lane (promoted, relocalized, lost)


def _vo_scan_step_batched(
    states: List[ScanVOState], gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig
) -> Tuple[List[ScanVOState], _StepOut]:
    """One frame of B sequences: ``states`` one per lane, gray and depth
    (B, H, W)."""
    trk = cfg.tracker
    b, dev = len(states), gray.device
    kf_b = stack_lanes([s.kf._replace(frame=None) for s in states])
    frame, res, _, T_w_curr, new_kf = frame_step_batched(
        gray, depth, kf_b, tracker.stack_past([s.past_voting for s in states]),
        stack_lanes([s.R for s in states]), stack_lanes([s.t for s in states]), cfg,
    )
    prev_T_w = stack_lanes([s.prev_T_w for s in states])
    T_nm1_n = stack_lanes([s.T_nm1_n for s in states])

    # Pose-jump gate on the initial track (host twin: VOSystem._is_jump).
    # The trace adds in float64, as torch.trace does on the CPU.
    inv_prev = lie.inv_lu(prev_T_w)
    d = lie.matmul_fma(inv_prev, T_w_curr)
    trace = (d[:, 0, 0].double() + d[:, 1, 1].double() + d[:, 2, 2].double()).float()
    cos_a = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    jump = (torch.linalg.vector_norm(d[:, :3, 3], dim=-1) > trk.max_jump_translation) | (
        torch.arccos(cos_a) > trk.max_jump_rotation
    )
    flags = torch.stack([
        new_kf, jump, res.error > trk.reloc_error_threshold, res.good < trk.reloc_min_good,
    ], dim=-1)
    host = flags.tolist()  # the per-frame host sync: one (B, 4) read
    T_w_coast = lie.matmul_fma(prev_T_w, T_nm1_n)

    # Host-loop order: a lost or jumped frame tries the ring before any
    # promotion logic, and a lost frame never promotes.
    if trk.scan_relocalization:
        lost = [jump_ or high_err or few_good for _, jump_, high_err, few_good in host]
    else:
        lost = [jump_ for _, jump_, _, _ in host]
    reloc = {}  # lane -> (keyframe, TrackResult) of a found candidate
    lost_lanes = [i for i in range(b) if lost[i]] if trk.scan_relocalization else []
    if lost_lanes:
        rings = [states[i].kf_ring for i in lost_lanes]
        res_alls = tracker.track_rings(rings, [lane(frame, i) for i in lost_lanes], cfg)
        picks = [tracker.select_reloc_candidate(r, ring.n, cfg)
                 for r, ring in zip(res_alls, rings)]
        picked = torch.stack([torch.stack([f.to(torch.int64), i]) for f, i, _ in picks]).tolist()
        for i, ring, (found, idx), (_, _, sel) in zip(lost_lanes, rings, picked, picks):
            if found:
                reloc[i] = (tracker.ring_keyframe(ring, idx, states[i].kf.frame), sel)

    promote = [host[i][0] and not states[i].just_added_kf and not lost[i] for i in range(b)]
    promoted = [i for i in range(b) if promote[i]]
    new_kfs = {}
    if promoted:
        kf_p = make_keyframe_batched(
            stack_lanes([states[i].prev for i in promoted]),
            stack_lanes([states[i].prev_T_w for i in promoted]), cfg,
        )
        T_p = stack_lanes([states[i].T_nm1_n for i in promoted])
        res_p = tracker.track_frames_batched(
            kf_p._replace(frame=None), stack_lanes([lane(frame, i) for i in promoted]),
            T_p[:, :3, :3], T_p[:, :3, 3], cfg,
        )
        new_kfs = {i: (lane(kf_p, j), lane(res_p, j)) for j, i in enumerate(promoted)}

    # Merge the outcomes lane by lane: relocalized > coasting > tracked.
    kfs, results, rings_next = [], [], []
    for i, s in enumerate(states):
        kf, r, ring = s.kf, lane(res, i), s.kf_ring
        if i in new_kfs:
            kf, r = new_kfs[i]
            if trk.scan_relocalization:
                ring = tracker.push_ring(s.kf_ring, kf, s.prev_T_w)
        if i in reloc:
            kf, r = reloc[i]
        kfs.append(kf)
        results.append(r)
        rings_next.append(ring)
    still_lost = [lost[i] and i not in reloc for i in range(b)]
    T_kf_n = lie.matrix_from_rt(stack_lanes([r.R for r in results]),
                                stack_lanes([r.t for r in results]))
    T_w_curr = lie.matmul_fma(stack_lanes([k.T_w_k for k in kfs]), T_kf_n)
    if any(still_lost):
        T_w_curr = stack_lanes([T_w_coast[i] if still_lost[i] else T_w_curr[i] for i in range(b)])
        T_kf_n = stack_lanes([
            lie.matmul_fma(lie.inv_lu(kfs[i].T_w_k), T_w_coast[i]) if still_lost[i] else T_kf_n[i]
            for i in range(b)
        ])

    # Motion prior (system.cpp:267-271).  On a coasted frame T_w_curr =
    # prev_T_w @ T_nm1_n, so the prior stays as it was.
    T_nm1_n = lie.matmul_fma(inv_prev, T_w_curr)
    T_init = lie.matmul_fma(T_kf_n, T_nm1_n)

    new_states = []
    for i, s in enumerate(states):
        # Rings: a still-lost frame adds nothing (the host loop returns
        # before _push_past).  On promotion the voting set freezes to the
        # rolling ring's pre-current contents (clearUpPastLists,
        # tracker.cpp:248-257); before the first promotion it fills with
        # the first K frames.
        past, voting = s.past, s.past_voting
        f = lane(frame, i)
        if not still_lost[i]:
            cl = f.levels[trk.histogram_level].cloud
            if promote[i]:
                voting = s.past
            elif voting.n < voting.points.shape[0]:
                voting = tracker.push_past(voting, cl.points, cl.valid, T_w_curr[i])
            past = tracker.push_past(s.past, cl.points, cl.valid, T_w_curr[i])
        if not cfg.init_from_last_pose:
            R_next, t_next = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        elif still_lost[i]:
            R_next, t_next = s.R, s.t
        else:
            R_next, t_next = T_init[i, :3, :3], T_init[i, :3, 3]
        new_states.append(ScanVOState(
            kf=kfs[i], prev=f, prev_T_w=T_w_curr[i], past=past, past_voting=voting,
            R=R_next, t=t_next, T_nm1_n=T_nm1_n[i], just_added_kf=promote[i],
            n_keyframes=s.n_keyframes + int(promote[i]), kf_ring=rings_next[i],
        ))
    out = _StepOut(
        T_w=T_w_curr, error=stack_lanes([r.error for r in results]),
        good=stack_lanes([r.good for r in results]),
        flags=[(promote[i], i in reloc, still_lost[i]) for i in range(b)],
    )
    return new_states, out


def scan_state_template(cfg: SystemConfig, device="cuda") -> ScanVOState:
    """A zero-data ScanVOState with the structure and shapes a scan under
    ``cfg`` carries: the restore target for checkpointed scan states
    (checkpoint.load_scan_state)."""
    h, w = cfg.camera.height, cfg.camera.width
    zeros = torch.zeros((h, w), dtype=torch.float32, device=device)
    return _init_state(build_frame(zeros, zeros, cfg), cfg)


def _scan_lanes(
    states: List[ScanVOState], grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig
) -> Tuple[ScanVOOutput, List[ScanVOState]]:
    """Step B lanes' states over (B, N, H, W) frames; returns the per-frame
    outputs with leading (B, N) axes and the final states."""
    b, n = grays.shape[:2]
    dev = grays.device
    steps = []
    for k in range(n):
        states, out = _vo_scan_step_batched(states, grays[:, k], depths[:, k], cfg)
        steps.append(out)
    if steps:
        T_w = torch.stack([o.T_w for o in steps], dim=1)
        error = torch.stack([o.error for o in steps], dim=1)
        good = torch.stack([o.good for o in steps], dim=1)
    else:
        T_w = torch.zeros((b, 0, 4, 4), device=dev)
        error = torch.zeros((b, 0), device=dev)
        good = torch.zeros((b, 0), dtype=torch.int32, device=dev)
    flags = torch.tensor([[o.flags[i] for o in steps] for i in range(b)], dtype=torch.bool,
                         device=dev).reshape(b, n, 3)
    outs = ScanVOOutput(T_w=T_w, error=error, good=good, promoted=flags[..., 0],
                        relocalized=flags[..., 1], lost=flags[..., 2])
    return outs, states


def vo_scan_from_state(
    state: ScanVOState, grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig
) -> Tuple[torch.Tensor, ScanVOOutput, ScanVOState]:
    """Continue VO from a carried ScanVOState over (N, H, W) frames; returns
    (poses (N, 4, 4), per-frame outputs, final state).  ``vo_scan(g, d)``
    is ``vo_scan_from_state(init, g[1:], d[1:])`` after frame 0."""
    outs, states = _scan_lanes([state], grays[None], depths[None], cfg)
    outs = lane(outs, 0)
    return outs.T_w, outs, states[0]


def vo_scan_lanes(
    grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig
) -> Tuple[ScanVOOutput, List[ScanVOState]]:
    """Full VO over (B, N, H, W) sequences stepped together; frame 0 of
    each is its first keyframe with identity pose."""
    if not (isinstance(grays, torch.Tensor) and isinstance(depths, torch.Tensor)):
        raise TypeError("vo_scan takes torch tensors on the device that runs it")
    states = _init_states(build_frame_batched(grays[:, 0], depths[:, 0], cfg), cfg)
    outs, states = _scan_lanes(states, grays[:, 1:], depths[:, 1:], cfg)
    b, dev = grays.shape[0], grays.device
    first = ScanVOOutput(
        T_w=torch.eye(4, device=dev).expand(b, 1, 4, 4),
        error=torch.zeros((b, 1), device=dev),
        good=torch.zeros((b, 1), dtype=outs.good.dtype, device=dev),
        promoted=torch.zeros((b, 1), dtype=torch.bool, device=dev),
        relocalized=torch.zeros((b, 1), dtype=torch.bool, device=dev),
        lost=torch.zeros((b, 1), dtype=torch.bool, device=dev),
    )
    return ScanVOOutput(*(torch.cat([a, x], dim=1) for a, x in zip(first, outs))), states


def vo_scan(
    grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig
) -> Tuple[torch.Tensor, ScanVOOutput, ScanVOState]:
    """Full VO over one preloaded sequence ((N, H, W) gray + depth tensors,
    on the device that runs it).  Returns (poses (N, 4, 4) world-from-
    camera, per-frame outputs, final state).  Frame 0 is the first keyframe
    with identity pose."""
    if not (isinstance(grays, torch.Tensor) and isinstance(depths, torch.Tensor)):
        raise TypeError("vo_scan takes (N, H, W) torch tensors on the device that runs it")
    outs, states = vo_scan_lanes(grays[None], depths[None], cfg)
    outs = lane(outs, 0)
    return outs.T_w, outs, states[0]


def vo_scan_batched(grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig, mesh=None,
                    axis: str = "seq") -> torch.Tensor:
    """Multi-sequence VO: (B, N, H, W) inputs -> (B, N, 4, 4) poses, the B
    sequences stepped together, one batched scan step per frame; each lane
    is bit-equal to ``vo_scan`` of its sequence.  With ``mesh`` the
    sequences are sharded over ``axis`` (B must divide by its size): each
    slot steps its share as one batch on its device and the poses are
    gathered in order, on the first slot's device (on every rank under a
    process group)."""
    if mesh is None:
        return vo_scan_lanes(grays, depths, cfg)[0].T_w
    parts = [vo_scan_batched(g, d, cfg)
             for g, d in zip(shard(grays, mesh, axis), shard(depths, mesh, axis))]
    return gather(parts, mesh, axis)
