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

The 4x4 algebra rounds as jitted XLA on the CPU does (``lie.matmul_fma``,
``lie.inv_lu``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from revo_tpu_torch import lie, tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import Frame, Keyframe, build_frame, make_keyframe
from revo_tpu_torch.parallel.mesh import gather, shard
from revo_tpu_torch.system import frame_step
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


def _init_state(frame0: Frame, cfg: SystemConfig) -> ScanVOState:
    dev = frame0.levels[0].gray.device
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    kf = make_keyframe(frame0, eye4, cfg)
    lvl = cfg.tracker.histogram_level
    past = tracker.empty_past(
        cfg.tracker.n_frames_histogram_voting, cfg.pyramid.edge_capacity[lvl], dev
    )
    cl = frame0.levels[lvl].cloud
    past = tracker.push_past(past, cl.points, cl.valid, eye4)
    ring = (
        tracker.ring_from_keyframe(kf, cfg.tracker.kf_history_size)
        if cfg.tracker.scan_relocalization
        else None
    )
    return ScanVOState(
        kf=kf, prev=frame0, prev_T_w=eye4, past=past, past_voting=past,
        R=torch.eye(3, device=dev), t=torch.zeros(3, device=dev), T_nm1_n=eye4,
        just_added_kf=True, n_keyframes=1, kf_ring=ring,
    )


def _vo_scan_step(
    state: ScanVOState, gray: torch.Tensor, depth: torch.Tensor, cfg: SystemConfig
) -> Tuple[ScanVOState, ScanVOOutput]:
    trk = cfg.tracker
    dev = gray.device
    frame, res, _, T_w_curr, new_kf = frame_step(
        gray, depth, state.kf, state.past_voting, state.R, state.t, cfg
    )

    # Pose-jump gate on the initial track (host twin: VOSystem._is_jump).
    inv_prev = lie.inv_lu(state.prev_T_w)
    d = lie.matmul_fma(inv_prev, T_w_curr)
    cos_a = torch.clamp((torch.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    jump = (torch.linalg.vector_norm(d[:3, 3]) > trk.max_jump_translation) | (
        torch.arccos(cos_a) > trk.max_jump_rotation
    )
    flags = torch.stack([
        new_kf, jump, res.error > trk.reloc_error_threshold, res.good < trk.reloc_min_good,
    ])
    new_kf, jump, high_err, few_good = flags.tolist()  # the per-frame host sync
    T_w_coast = lie.matmul_fma(state.prev_T_w, state.T_nm1_n)

    found = False
    if trk.scan_relocalization:
        # Host-loop order: a lost or jumped frame tries the ring before any
        # promotion logic, and a lost frame never promotes.
        lost = jump or high_err or few_good
        if lost:
            res_all = tracker.track_ring(state.kf_ring, frame, cfg)
            found_t, idx, sel = tracker.select_reloc_candidate(res_all, state.kf_ring.n, cfg)
            found = bool(found_t)
            if found:
                kf_reloc = tracker.ring_keyframe(state.kf_ring, int(idx), state.kf.frame)
    else:
        lost = jump
    still_lost = lost and not found

    promote = new_kf and not state.just_added_kf and not lost
    kf, kf_ring = state.kf, state.kf_ring
    if promote:
        kf = make_keyframe(state.prev, state.prev_T_w, cfg)
        res = tracker.track_frames(kf, frame, state.T_nm1_n[:3, :3], state.T_nm1_n[:3, 3], cfg)
        if trk.scan_relocalization:
            kf_ring = tracker.push_ring(state.kf_ring, kf, state.prev_T_w)
    if found:  # relocalized > coasting > tracked
        kf, res = kf_reloc, sel
    T_kf_n = lie.matrix_from_rt(res.R, res.t)
    T_w_curr = lie.matmul_fma(kf.T_w_k, T_kf_n)
    if still_lost:
        T_w_curr = T_w_coast
        T_kf_n = lie.matmul_fma(lie.inv_lu(kf.T_w_k), T_w_coast)

    # Rings: a still-lost frame adds nothing (the host loop returns before
    # _push_past).  On promotion the voting set freezes to the rolling
    # ring's pre-current contents (clearUpPastLists, tracker.cpp:248-257);
    # before the first promotion it fills with the first K frames.
    past, voting = state.past, state.past_voting
    if not still_lost:
        cl = frame.levels[trk.histogram_level].cloud
        if promote:
            voting = state.past
        elif voting.n < voting.points.shape[0]:
            voting = tracker.push_past(voting, cl.points, cl.valid, T_w_curr)
        past = tracker.push_past(state.past, cl.points, cl.valid, T_w_curr)

    # Motion prior (system.cpp:267-271).  On a coasted frame T_w_curr =
    # prev_T_w @ T_nm1_n, so the prior stays as it was.
    T_nm1_n = lie.matmul_fma(inv_prev, T_w_curr)
    if not cfg.init_from_last_pose:
        R_next, t_next = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    elif still_lost:
        R_next, t_next = state.R, state.t
    else:
        T_init = lie.matmul_fma(T_kf_n, T_nm1_n)
        R_next, t_next = T_init[:3, :3], T_init[:3, 3]

    new_state = ScanVOState(
        kf=kf, prev=frame, prev_T_w=T_w_curr, past=past, past_voting=voting,
        R=R_next, t=t_next, T_nm1_n=T_nm1_n, just_added_kf=promote,
        n_keyframes=state.n_keyframes + int(promote), kf_ring=kf_ring,
    )

    def flag(b):
        return torch.tensor(b, device=dev)

    out = ScanVOOutput(
        T_w=T_w_curr, error=res.error, good=res.good, promoted=flag(promote),
        relocalized=flag(found), lost=flag(still_lost),
    )
    return new_state, out


def scan_state_template(cfg: SystemConfig, device="cuda") -> ScanVOState:
    """A zero-data ScanVOState with the structure and shapes a scan under
    ``cfg`` carries: the restore target for checkpointed scan states
    (checkpoint.load_scan_state)."""
    h, w = cfg.camera.height, cfg.camera.width
    zeros = torch.zeros((h, w), dtype=torch.float32, device=device)
    return _init_state(build_frame(zeros, zeros, cfg), cfg)


def _stack_outputs(outs) -> ScanVOOutput:
    return ScanVOOutput(*(torch.stack(field) for field in zip(*outs)))


def vo_scan_from_state(
    state: ScanVOState, grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig
) -> Tuple[torch.Tensor, ScanVOOutput, ScanVOState]:
    """Continue VO from a carried ScanVOState over (N, H, W) frames; returns
    (poses (N, 4, 4), per-frame outputs, final state).  ``vo_scan(g, d)``
    is ``vo_scan_from_state(init, g[1:], d[1:])`` after frame 0."""
    outs = []
    for gray, depth in zip(grays, depths):
        state, out = _vo_scan_step(state, gray, depth, cfg)
        outs.append(out)
    outs = _stack_outputs(outs)
    return outs.T_w, outs, state


def vo_scan(
    grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig
) -> Tuple[torch.Tensor, ScanVOOutput, ScanVOState]:
    """Full VO over one preloaded sequence ((N, H, W) gray + depth tensors,
    on the device that runs it).  Returns (poses (N, 4, 4) world-from-
    camera, per-frame outputs, final state).  Frame 0 is the first keyframe
    with identity pose."""
    if not (isinstance(grays, torch.Tensor) and isinstance(depths, torch.Tensor)):
        raise TypeError("vo_scan takes (N, H, W) torch tensors on the device that runs it")
    state0 = _init_state(build_frame(grays[0], depths[0], cfg), cfg)
    _, outs, final_state = vo_scan_from_state(state0, grays[1:], depths[1:], cfg)
    dev = grays.device
    first = ScanVOOutput(
        T_w=torch.eye(4, device=dev), error=torch.zeros((), device=dev),
        good=torch.zeros((), dtype=outs.good.dtype, device=dev),
        promoted=torch.tensor(False, device=dev), relocalized=torch.tensor(False, device=dev),
        lost=torch.tensor(False, device=dev),
    )
    outs_full = ScanVOOutput(
        *(torch.cat([a[None], b]) for a, b in zip(first, outs))
    )
    return outs_full.T_w, outs_full, final_state


def vo_scan_batched(grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig, mesh=None,
                    axis: str = "seq") -> torch.Tensor:
    """Multi-sequence VO: (B, N, H, W) inputs -> (B, N, 4, 4) poses, one
    vo_scan per sequence in turn.  With ``mesh`` the sequences are sharded
    over ``axis`` (B must divide by its size): each slot scans its share on
    its device and the poses are gathered in order, on the first slot's
    device (on every rank under a process group).  Each sequence runs the
    same program either way, so the result is bit-equal to the mesh-less
    loop on the same devices."""
    if mesh is None:
        return torch.stack([vo_scan(g, d, cfg)[0] for g, d in zip(grays, depths)])
    parts = [vo_scan_batched(g, d, cfg)
             for g, d in zip(shard(grays, mesh, axis), shard(depths, mesh, axis))]
    return gather(parts, mesh, axis)
