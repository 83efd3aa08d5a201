"""Coarse-to-fine SE(3) tracking and keyframe selection (counterpart of
revo_tpu/tracker.py).

TrackerNew::trackFrames (tracker.cpp:294-353): check the initial pose
against identity, then solve each pyramid level from PYR_MIN_LVL (coarse)
down to PYR_MAX_LVL (fine), each level starting from the previous one's
pose.  Around it: per-frame capacity bucketing, the past-frame ring and the
IROS17 histogram-voting keyframe test (assessTrackingQuality,
tracker.cpp:118-201), and the ring of recent keyframes that relocalization
searches.

The rings' fill counts ``n`` are Python ints: the loops that drive them read
them on the host anyway, and a host count keeps every push free of device
syncs.

Tracking and voting run B lanes at once (``track_frames_batched``,
``assess_tracking_quality_batched``: a leading lane axis on the keyframe's
tables, the frame's clouds and the poses; a batched PastFrames holds one
``n`` per lane), what the JAX package gets from ``vmap``.  Each lane's bits
are those it gets alone; ``track_frames`` and ``assess_tracking_quality``
are the B = 1 case, and ``track_ring`` tracks a frame against all active
ring slots as one batch.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from revo_tpu_torch import lie, solver
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import Frame, FrameLevel, Keyframe
from revo_tpu_torch.lanes import add_lane_axis, lane
from revo_tpu_torch.ops.project import scale_shift
from revo_tpu_torch.utils import trace


class TrackResult(NamedTuple):
    R: torch.Tensor  # (3, 3) keyframe <- current rotation
    t: torch.Tensor  # (3,)
    error: torch.Tensor  # () final mean weighted error
    good: torch.Tensor  # () int32
    bad: torch.Tensor  # () int32
    new_kf: torch.Tensor  # () bool: good/bad < good_bad_ratio_new_kf


def track_frames_batched(
    kf: Keyframe, frame: Frame, R0: torch.Tensor, t0: torch.Tensor, cfg: SystemConfig
) -> TrackResult:
    """Track B lanes at once: lane b's frame clouds against lane b's
    keyframe tables from (R0[b], t0[b]).  ``kf`` needs structs and quads
    with a leading lane axis (its ``frame`` is not read), ``frame`` its
    clouds; either may share one lane's tensors by ``expand``.  Returns a
    TrackResult with the lane axis.  Traced as ``tracker.track``."""
    with trace.span("tracker.track"):
        pyr = cfg.pyramid
        opt = cfg.tracker.optimizer
        cams = cfg.camera_pyramid()
        R, t = R0, t0
        check = None
        if cfg.tracker.check_init_values:
            # "DO NOT INIT WITH PREVIOUS TRANSFORM" (tracker.cpp:277-282), only
            # when identity is clearly better (TrackerConfig.init_check_margin):
            # the coarsest level runs the check before its start, inside its
            # launch on the card (``solver.level_state``).
            lvl = pyr.pyr_min_lvl
            check = solver.init_check_block(
                kf.structs[lvl], R.shape[0], opt.edge_distance_lvl[lvl], opt.use_edge_filter,
                cfg.tracker.normalized_init_cost, cfg.tracker.init_check_margin,
            )

        info = None
        err = None
        # A "quad*" bilinear_impl samples the quad table, any other the
        # structure itself as (H*W, 3) rows (revo_tpu/tracker.py:65-74).
        use_quad = solver.uses_quad_table(opt)
        for lvl in range(pyr.pyr_min_lvl, pyr.pyr_max_lvl - 1, -1):
            table = kf.quads[lvl] if use_quad else kf.structs[lvl].flatten(-3, -2)
            R, t, err, info = solver.solve_level_batched(
                table, frame.levels[lvl].cloud, cams[lvl], R, t, opt, lvl,
                check=check if lvl == pyr.pyr_min_lvl else None,
            )
        good_f = info.good.to(torch.float32)
        bad_f = torch.clamp(info.bad, min=1).to(torch.float32)
        new_kf = (good_f / bad_f) < cfg.tracker.good_bad_ratio_new_kf
        return TrackResult(R=R, t=t, error=err, good=info.good, bad=info.bad, new_kf=new_kf)


def track_frames(
    kf: Keyframe, frame: Frame, R0: torch.Tensor, t0: torch.Tensor, cfg: SystemConfig
) -> TrackResult:
    """Track ``frame`` against ``kf`` from the initial pose (R0, t0):
    ``track_frames_batched`` at B = 1."""
    res = track_frames_batched(
        add_lane_axis(kf._replace(frame=None)), add_lane_axis(frame), R0[None], t0[None], cfg
    )
    return lane(res, 0)


# -- capacity bucketing --------------------------------------------------------


def slice_cloud_frame(frame: Frame, buckets) -> Frame:
    """Slice each level's edge cloud to ``buckets[lvl]`` lanes.  Valid points
    fill the first ``count`` lanes, so whenever count <= bucket only
    invalid padding goes."""
    levels = tuple(
        lv._replace(
            cloud=lv.cloud._replace(points=lv.cloud.points[:b], valid=lv.cloud.valid[:b])
        )
        for lv, b in zip(frame.levels, buckets)
    )
    return frame._replace(levels=levels)


_BUCKET_RATIOS = (0.5, 0.625, 0.75, 0.875, 1.0)


def pick_buckets(counts, capacities, ratios=_BUCKET_RATIOS, quantum=256):
    """Per-frame lane counts: one shared fill ratio (the max over levels,
    quantized to ``ratios``), multiples of ``quantum`` capped at each
    level's capacity.  A frame that overflows keeps full capacity."""
    fill = max((c / cap) for c, cap in zip(counts, capacities)) if capacities else 1.0
    ratio = next((r for r in ratios if fill <= r), 1.0)
    return tuple(
        min(int(cap), max(quantum, -(-int(cap * ratio) // quantum) * quantum))
        for cap in capacities
    )


def track_frames_bucketed(
    kf: Keyframe, frame: Frame, R0, t0, cfg: SystemConfig
) -> TrackResult:
    """track_frames on the frame's clouds sliced to the smallest bucket that
    holds their points (one host read of the per-level counts).  The port
    compiles nothing per shape, so this is only the slice; results match
    track_frames to reduction order while no level overflows."""
    counts = [int(lv.cloud.count) for lv in frame.levels]
    caps = [lv.cloud.points.shape[0] for lv in frame.levels]
    return track_frames(kf, slice_cloud_frame(frame, pick_buckets(counts, caps)), R0, t0, cfg)


# -- past-frame ring and histogram voting --------------------------------------


class PastFrames(NamedTuple):
    """Ring of K frames' histogram-level edge clouds and world poses
    (TrackerNew::mPastPcl / mPastWorldPoses, tracker.h:92-94).

    The system keeps two: a rolling ring of the newest K frames, and the
    frozen voting set, the K frames before the last promotion (or the first
    K frames before any), which revo_tpu/tracker.py::PastFrames explains.
    Slot 0 is the oldest; ``n`` counts the filled slots (<= K).  A batched
    PastFrames (``stack_past``) has a leading lane axis on the tensors and
    ``n`` a tuple of the lanes' counts.
    """

    points: torch.Tensor  # (K, P, 3) camera-frame points at histogram level
    valid: torch.Tensor  # (K, P) bool
    poses: torch.Tensor  # (K, 4, 4) world poses T_w_cam
    n: int


def empty_past(k: int, capacity: int, device) -> PastFrames:
    return PastFrames(
        points=torch.zeros((k, capacity, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((k, capacity), dtype=torch.bool, device=device),
        poses=torch.eye(4, dtype=torch.float32, device=device).repeat(k, 1, 1),
        n=0,
    )


def push_past(past: PastFrames, points, valid, pose_w) -> PastFrames:
    """addOldPclAndPose with the trim folded in (tracker.cpp:209-223,
    248-257): append at slot ``n`` until full, then drop the oldest and
    append at slot K-1; ``n`` saturates at K."""
    k = past.points.shape[0]

    def put(arr, new):
        new = new.to(arr.dtype)
        if past.n >= k:
            return torch.cat([arr[1:], new[None]])
        out = arr.clone()
        out[past.n] = new
        return out

    return PastFrames(
        points=put(past.points, points),
        valid=put(past.valid, valid),
        poses=put(past.poses, pose_w),
        n=min(past.n + 1, k),
    )


def stack_past(pasts) -> PastFrames:
    """B lanes' PastFrames as one batched PastFrames: a leading lane axis on
    the tensors and ``n`` a tuple of the lanes' counts."""
    return PastFrames(
        points=torch.stack([p.points for p in pasts]),
        valid=torch.stack([p.valid for p in pasts]),
        poses=torch.stack([p.poses for p in pasts]),
        n=tuple(p.n for p in pasts),
    )


def counting_map_batched(past: PastFrames, est_pose_w: torch.Tensor,
                         cfg: SystemConfig) -> torch.Tensor:
    """``counting_map`` of B lanes (a batched PastFrames, est_pose_w
    (B, 4, 4)) -> (B, H, W) int32, without a host sync past the LU
    inverse: the marks of each lane's active slots land in one scatter."""
    cam = cfg.camera_pyramid()[cfg.tracker.histogram_level]
    h, w = cam.height, cam.width
    k, dev = past.points.shape[1], past.points.device
    inv_est = lie.inv_lu(est_pose_w)
    T = lie.matmul_fma(inv_est[:, None], past.poses)  # past cam -> current cam
    wxp = lie.matmul_fma(past.points, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]
    pz = torch.where(wxp[..., 2] == 0, 1e-12, wxp[..., 2])
    u = scale_shift(wxp[..., 0] / pz, cam.fx, cam.cx)
    v = scale_shift(wxp[..., 1] / pz, cam.fy, cam.cy)
    slots = torch.stack([torch.arange(k, device=dev) < n for n in past.n])
    inb = (u >= 0) & (v >= 0) & (u < w) & (v < h) & past.valid & slots[..., None]
    ui = torch.where(inb, torch.floor(u), 0.0).to(torch.int64)
    vi = torch.where(inb, torch.floor(v), 0.0).to(torch.int64)
    lin = torch.where(inb, vi * w + ui, h * w)
    hit = torch.zeros((*inb.shape[:-1], h * w + 1), dtype=torch.bool, device=dev)
    hit = hit.scatter_(-1, lin, True)[..., : h * w]  # M_i: binary per slot
    return hit.sum(1, dtype=torch.int32).reshape(-1, h, w)


def counting_map(past: PastFrames, est_pose_w: torch.Tensor, cfg: SystemConfig) -> torch.Tensor:
    """The IROS17 counting map M = sum_i M_i, (H, W) int32 at the histogram
    level: M_i marks the pixels that past slot i's edge points project to
    under the estimated pose (binary per slot; inactive slots mark nothing).

    The projection rounds as jitted XLA on the CPU does, because floor(u)
    decides the pixel: LU inverse of the estimated pose, FMA-chain 4x4 and
    point products (``lie.inv_lu``, ``lie.matmul_fma``), and
    ``u = x / z * fx + cx`` as one FMA (``ops.project.scale_shift``)."""
    return counting_map_batched(stack_past([past]), est_pose_w[None], cfg)[0]


def assess_tracking_quality_batched(
    past: PastFrames, est_pose_w: torch.Tensor, frame: Frame, cfg: SystemConfig
) -> torch.Tensor:
    """``assess_tracking_quality`` of B lanes (a batched PastFrames, est
    (B, 4, 4), a batched Frame) -> (B,) bool."""
    trk = cfg.tracker
    lvl = trk.histogram_level
    k = past.points.shape[1]
    depth = frame.levels[lvl].depth
    b = depth.shape[0]
    full = [n >= k for n in past.n]
    no = torch.zeros((), dtype=torch.bool, device=depth.device)
    if not any(full):
        return no.expand(b)
    m = counting_map_batched(past, est_pose_w, cfg).reshape(b, -1)
    valid_depth = (
        torch.isfinite(depth) & (depth > cfg.pyramid.depth_min) & (depth < cfg.pyramid.depth_max)
    )
    mask = (valid_depth & frame.levels[lvl].edges_orig).reshape(b, -1)
    # Exact integer counts, the role of JAX's one-hot contraction.
    overlaps = torch.zeros((b, k + 1), dtype=torch.int64, device=depth.device)
    overlaps = overlaps.scatter_add_(1, m.to(torch.int64), mask.to(torch.int64))
    overlaps = overlaps.to(torch.float32)
    # Integer counts times the weights, summed: exact in any order.
    weighted = sum(overlaps[:, j] * trk.hist_weights[j] for j in range(1, k + 1))
    vote = weighted < overlaps[:, 0]
    return torch.stack([vote[i] if full[i] else no for i in range(b)])


def assess_tracking_quality(
    past: PastFrames, est_pose_w: torch.Tensor, frame: Frame, cfg: SystemConfig
) -> torch.Tensor:
    """IROS17 histogram voting (assessTrackingQuality, tracker.cpp:118-201):
    histogram the counting map over the current frame's original edges with
    valid depth, and call for a new keyframe when the weighted overlap
    falls below the zero-overlap count.  Only once K past frames exist
    (histogram.size() < 4 guard, tracker.cpp:184).  Returns a () bool
    tensor on the frame's device."""
    return assess_tracking_quality_batched(
        stack_past([past]), est_pose_w[None], add_lane_axis(frame), cfg
    )[0]


# -- relocalization ring --------------------------------------------------------


class KeyframeRing(NamedTuple):
    """Ring of recent keyframes' tracking state (DT structs, quad tables,
    world poses) that relocalization searches.  Slot 0 is the NEWEST;
    ``n`` counts the active slots."""

    structs: Tuple[torch.Tensor, ...]  # per level (K, H, W, 3)
    quads: Tuple[torch.Tensor, ...]  # per level (K, H*W, C), ``ops.edt.quad_structure``
    T_w_k: torch.Tensor  # (K, 4, 4) keyframe-to-world poses
    n: int


def _tile(x: torch.Tensor, k: int) -> torch.Tensor:
    return x[None].repeat(k, *([1] * x.dim()))


def ring_from_keyframe(kf: Keyframe, k: int) -> KeyframeRing:
    """Initial ring: slot 0 holds ``kf``; the other slots are inactive
    copies of it."""
    return KeyframeRing(
        structs=tuple(_tile(s, k) for s in kf.structs),
        quads=tuple(_tile(q, k) for q in kf.quads),
        T_w_k=_tile(kf.T_w_k.to(torch.float32), k),
        n=1,
    )


def push_ring(ring: KeyframeRing, kf: Keyframe, T_w_k: torch.Tensor) -> KeyframeRing:
    """Push a newly promoted keyframe into slot 0; the oldest falls off."""

    def push(arr, new):
        return torch.cat([new.to(arr.dtype)[None], arr[:-1]])

    return KeyframeRing(
        structs=tuple(push(a, s) for a, s in zip(ring.structs, kf.structs)),
        quads=tuple(push(a, q) for a, q in zip(ring.quads, kf.quads)),
        T_w_k=push(ring.T_w_k, T_w_k),
        n=min(ring.n + 1, ring.T_w_k.shape[0]),
    )


def ring_keyframe(ring: KeyframeRing, slot: int, frame: Frame) -> Keyframe:
    """Ring slot ``slot`` as a Keyframe.  The ring keeps no images, so
    ``frame`` stands in for its own; tracking never reads ``kf.frame``."""
    return Keyframe(
        structs=tuple(s[slot] for s in ring.structs),
        quads=tuple(q[slot] for q in ring.quads),
        frame=frame,
        T_w_k=ring.T_w_k[slot],
    )


def track_rings(rings, frames, cfg: SystemConfig):
    """Track each frame from identity against every active slot of its
    ring, all (frame, slot) pairs in one batch; returns per ring the
    results stacked along a leading slot axis, newest first.  Inactive
    slots are never selected, so they are not tracked: their rows hold
    error inf and good 0."""
    dev = rings[0].T_w_k.device
    n_levels = len(rings[0].quads)

    def cat(parts):  # one ring's slices stay views
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    quads = tuple(cat([r.quads[lvl][:r.n] for r in rings]) for lvl in range(n_levels))
    structs = tuple(cat([r.structs[lvl][:r.n] for r in rings]) for lvl in range(n_levels))

    def cloud(lvl):  # each frame's cloud once per slot of its ring
        parts = [add_lane_axis(f.levels[lvl].cloud, r.n) for r, f in zip(rings, frames)]
        return type(parts[0])(*(cat(list(field)) for field in zip(*parts)))

    clouds = Frame(levels=tuple(FrameLevel(None, None, None, None, cloud(lvl))
                                for lvl in range(n_levels)), timestamp=None)
    total = sum(r.n for r in rings)
    kf = Keyframe(structs=structs, quads=quads, frame=None, T_w_k=None)
    res = track_frames_batched(
        kf, clouds,
        torch.eye(3, device=dev).expand(total, 3, 3), torch.zeros(3, device=dev).expand(total, 3),
        cfg,
    )
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    inactive = TrackResult(
        R=torch.eye(3, device=dev), t=torch.zeros(3, device=dev),
        error=torch.full((), float("inf"), device=dev), good=izero, bad=izero,
        new_kf=torch.zeros((), dtype=torch.bool, device=dev),
    )
    out, start = [], 0
    for r in rings:
        k = r.T_w_k.shape[0]
        rows = [lane(res, start + i) for i in range(r.n)] + [inactive] * (k - r.n)
        out.append(TrackResult(*(torch.stack(field) for field in zip(*rows))))
        start += r.n
    return out


def track_ring(ring: KeyframeRing, frame: Frame, cfg: SystemConfig) -> TrackResult:
    """Track ``frame`` from identity against every active ring keyframe in
    one batch, the frame's clouds shared by the slots (stride 0).  Returns
    the per-slot results stacked along a leading slot axis, newest first."""
    return track_rings([ring], [frame], cfg)[0]


def select_reloc_candidate(res_all: TrackResult, ring_n: int, cfg: SystemConfig):
    """Best relocalization candidate: an active slot that passes the lost
    thresholds (reloc_error_threshold / reloc_min_good), lowest error, ties
    to the newest (argmin's first occurrence on the newest-first order).
    Returns (found () bool, idx () int64, the selected TrackResult)."""
    trk = cfg.tracker
    err = res_all.error
    active = torch.arange(err.shape[0], device=err.device) < ring_n
    bad = (err > trk.reloc_error_threshold) | (res_all.good < trk.reloc_min_good) | ~active
    score = torch.where(bad, float("inf"), err)
    idx = torch.argmin(score)
    found = torch.isfinite(score[idx])
    return found, idx, TrackResult(*(f[idx] for f in res_all))
