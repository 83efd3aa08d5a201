"""The VO system loop: frame loop, keyframe promotion, relocalization, pose
graph (counterpart of revo_tpu/system.py).

REVO::start (system/system.cpp:84-305).  The host orchestrates; every
per-frame computation (pyramid, tracking, voting) runs on the system's
device, and the pose algebra between frames is host numpy, as in the JAX
package.  Control flow mirrors the reference:

- frame 0 becomes the first keyframe (system.cpp:151-175);
- per frame: track against the keyframe, then the histogram-voting quality
  check overwrites the tracker's good/bad-ratio status (system.cpp:188-199);
- on NEW_KF (and not right after a promotion) the previous frame becomes
  the keyframe and the current frame is re-tracked against it from the
  frame-to-frame motion prior (system.cpp:203-241);
- motion prior: T_init = T_kf_N * T_{N-1,N} (system.cpp:267-271);
- a frame whose residual or motion says the track failed is relocalized
  against the ring of recent keyframes, or coasts on the motion prior;
- with ``TrackerConfig.online_loop_closure``, verified revisits among the
  retained keyframes are closed mid-run (loopclosure.close_loops) and the
  correction reaches the live state.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional

import numpy as np
import torch

from revo_tpu_torch import lie, tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import (
    Frame, Keyframe, build_frame, build_frame_batched, make_keyframe, prune_keyframe,
)
from revo_tpu_torch.io.tum import write_tum_trajectory
from revo_tpu_torch.kernels import check_device
from revo_tpu_torch.lanes import add_lane_axis, lane
from revo_tpu_torch.ops.undistort import build_undistort_maps
from revo_tpu_torch.utils import trace


class TrackerStatus(enum.Enum):
    """TrackerNew::TrackerStatus (tracker.h:61-66)."""

    OK = 0
    LOST = 1
    NEW_KF = 2
    UNKNOWN = 3


@dataclasses.dataclass
class PoseNode:
    """REVO::Pose (system.h:89-152): relative pose anchored to a keyframe."""

    T_kf_curr: np.ndarray  # (4, 4)
    T_w_kf: np.ndarray  # parent keyframe world pose at creation/promotion
    timestamp: float
    is_keyframe: bool = False
    kf_ordinal: int = 0  # ordinal of the parent keyframe

    @property
    def T_w_curr(self) -> np.ndarray:
        """getCurrToWorld = T_w_kf * T_kf_curr (system.h:130-133)."""
        return self.T_w_kf @ self.T_kf_curr

    def promote_to_keyframe(self) -> None:
        """setKfFrame (system.h:140-146): node becomes its own keyframe."""
        self.T_w_kf = self.T_w_curr
        self.T_kf_curr = np.eye(4, dtype=np.float32)
        self.is_keyframe = True


@dataclasses.dataclass
class VOReport:
    """End-of-run VO report (system.cpp:292-304), with per-frame latency
    percentiles beside the means: a 30 Hz sensor feeds the reference, and a
    mean hides the stalls of promotion re-tracks and relocalizations."""

    frames_tracked: int = 0
    keyframes: int = 0
    tracking_lost: int = 0
    mean_dt_time_ms: float = 0.0  # make_keyframe's device ms (host ms on the CPU)
    mean_tracking_time_ms: float = 0.0
    latency_ms_p50: float = 0.0
    latency_ms_p95: float = 0.0
    latency_ms_p99: float = 0.0


def frame_step_batched(gray, depth, kf: Keyframe, past_voting, R0, t0, cfg: SystemConfig,
                       undistort_maps=None):
    """One frame of B sequences at once: pyramid build of (B, H, W) gray
    and depth (rectified first when ``undistort_maps`` is given), a
    coarse-to-fine track of each lane against its keyframe (``kf`` with a
    leading lane axis, poses R0 (B, 3, 3), t0 (B, 3)) and each lane's
    histogram vote (``past_voting`` a batched PastFrames,
    ``tracker.stack_past``), traced as ``frontend.build``, ``tracker.track``
    and ``keyframe.vote``.  Returns (frame, result, T_kf_n, T_w_curr,
    new_kf), each with the lane axis."""
    frame = build_frame_batched(gray, depth, cfg, undistort_maps)
    res = tracker.track_frames_batched(kf, frame, R0, t0, cfg)
    T_kf_n = lie.matrix_from_rt(res.R, res.t)
    T_w_curr = lie.matmul_fma(kf.T_w_k, T_kf_n)
    if cfg.tracker.check_tracking_results:
        with trace.span("keyframe.vote"):
            new_kf = tracker.assess_tracking_quality_batched(past_voting, T_w_curr, frame, cfg)
    else:
        new_kf = torch.zeros(gray.shape[:1], dtype=torch.bool, device=T_w_curr.device)
    return frame, res, T_kf_n, T_w_curr, new_kf


def frame_step(gray, depth, kf: Keyframe, past_voting, R0, t0, cfg: SystemConfig,
               undistort_maps=None):
    """``frame_step_batched`` of one frame against one keyframe.  Returns
    (frame, result, T_kf_n, T_w_curr, new_kf)."""
    out = frame_step_batched(
        gray[None], depth[None], add_lane_axis(kf._replace(frame=None)),
        tracker.stack_past([past_voting]), R0[None], t0[None], cfg, undistort_maps,
    )
    return lane(out, 0)


def _np(x: torch.Tensor) -> np.ndarray:
    with trace.host_read("system.read"):
        return x.detach().cpu().numpy()


class VOSystem:
    """Visual odometry over a stream of (gray, depth, timestamp) frames on
    ``device``.  Frames may be numpy arrays or tensors: uint8 or float32
    gray, uint16 raw or float32 metric depth."""

    def __init__(self, cfg: SystemConfig, device):
        self.cfg = cfg
        self.device = check_device(device)
        # Rectification maps (camerapyr.h:125-137): built once on the host,
        # held on the system's device.
        self.undistort_maps = None
        if cfg.pyramid.undistort:
            self.undistort_maps = tuple(
                torch.from_numpy(m).to(self.device) for m in build_undistort_maps(cfg.camera)
            )
        self.pose_graph: List[PoseNode] = []
        self.kf: Optional[Keyframe] = None
        self.prev_frame: Optional[Frame] = None
        self.past = tracker.empty_past(  # rolling: newest K frames
            cfg.tracker.n_frames_histogram_voting,
            cfg.pyramid.edge_capacity[cfg.tracker.histogram_level],
            self.device,
        )
        # Frozen voting set: the K frames preceding the last promotion.
        self.past_voting = self.past
        self.R = torch.eye(3, device=self.device)
        self.t = torch.zeros(3, device=self.device)
        self.T_nm1_n = np.eye(4, dtype=np.float32)
        self.just_added_kf = False
        self.n_frames = 0
        self.n_keyframes = 0
        self.n_tracking_lost = 0
        self.n_relocalized = 0
        # Recent keyframes for relocalization as (ordinal, Keyframe); slot i
        # of reloc_ring (newest first) is kf_history[-1 - i].
        self.kf_history: List[tuple] = []
        self.reloc_ring: Optional[tracker.KeyframeRing] = None
        self.kf_ordinal_current = 0
        # Each make_keyframe's (start, end): CUDA events on the card, the
        # host clock's seconds on the CPU; ``keyframe_ms`` reads them.
        self.dt_times: List[tuple] = []
        self.tracking_times: List[float] = []

    # -- helpers -------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _mark(self):
        """A point on the device's timeline: a recorded CUDA event on the
        card (no host wait), the host clock on the CPU."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def keyframe_ms(self) -> List[float]:
        """Each make_keyframe's ms on the device (the host's on the CPU);
        waits for the last keyframe's work."""
        out = []
        for a, b in self.dt_times:
            if isinstance(a, float):
                out.append((b - a) * 1000.0)
            else:
                b.synchronize()
                out.append(a.elapsed_time(b))
        return out

    def _push_past(self, frame: Frame, T_w_curr: np.ndarray) -> None:
        cloud = frame.levels[self.cfg.tracker.histogram_level].cloud
        pose = self._tensor(np.asarray(T_w_curr, np.float32))
        self.past = tracker.push_past(self.past, cloud.points, cloud.valid, pose)
        # Before the first promotion the voting set accumulates the first K
        # frames (the untrimmed deque's front in the reference).
        if self.past_voting.n < self.past_voting.points.shape[0]:
            self.past_voting = tracker.push_past(
                self.past_voting, cloud.points, cloud.valid, pose
            )

    def _make_keyframe(self, frame: Frame, T_w_k: np.ndarray) -> None:
        T_w_k = self._tensor(np.asarray(T_w_k, np.float32))
        start = self._mark()
        self.kf = make_keyframe(frame, T_w_k, self.cfg)
        self.dt_times.append((start, self._mark()))
        self.n_keyframes += 1
        self.kf_ordinal_current = self.n_keyframes - 1
        kf_store = self.kf if self.cfg.tracker.store_kf_images else prune_keyframe(self.kf)
        self.kf_history.append((self.kf_ordinal_current, kf_store))
        if len(self.kf_history) > self.cfg.tracker.kf_history_size:
            self.kf_history.pop(0)
        if self.cfg.tracker.enable_relocalization:
            if self.reloc_ring is None:
                self.reloc_ring = tracker.ring_from_keyframe(
                    self.kf, self.cfg.tracker.kf_history_size
                )
            else:
                self.reloc_ring = tracker.push_ring(self.reloc_ring, self.kf, T_w_k)

    def _is_jump(self, T_w_curr: np.ndarray) -> bool:
        """Catastrophic frame-to-frame motion gate (TrackerConfig
        max_jump_*): catches wrong-basin convergences whose DT residual
        stays low, which _is_lost cannot see."""
        if not self.pose_graph:
            return False
        trk = self.cfg.tracker
        d = np.linalg.inv(self.pose_graph[-1].T_w_curr) @ T_w_curr
        if np.linalg.norm(d[:3, 3]) > trk.max_jump_translation:
            return True
        cos_a = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        return bool(np.arccos(cos_a) > trk.max_jump_rotation)

    def _is_lost(self, res) -> bool:
        """Residual-based failure detector: mean error above
        reloc_error_threshold or fewer than reloc_min_good inliers."""
        trk = self.cfg.tracker
        with trace.host_read("system.lost"):
            return bool(
                float(res.error) > trk.reloc_error_threshold
                or int(res.good) < trk.reloc_min_good
            )

    def _relocalize(self, frame: Frame):
        """Track against the recent-keyframe ring from identity; return
        (ordinal, keyframe, result) of the best candidate, or Nones (the
        reference's TRACKER_STATE_LOST dead-ends, tracker.h:62-65)."""
        if self.reloc_ring is None:
            return (None, None, None)
        res_all = tracker.track_ring(self.reloc_ring, frame, self.cfg)
        found, idx, sel = tracker.select_reloc_candidate(res_all, self.reloc_ring.n, self.cfg)
        if not bool(found):
            return (None, None, None)
        ordinal, kf = self.kf_history[len(self.kf_history) - 1 - int(idx)]
        return ordinal, kf, sel

    def _online_loop_closure(self) -> int:
        """Mid-run loop closure (TrackerConfig.online_loop_closure): close
        verified revisits over the retained keyframes and carry the
        correction into the live state: retained keyframes, pose-graph
        anchors, the current keyframe, the past and voting rings (shifted by
        the current keyframe's correction delta, since their recent frames
        anchor to it) and the relocalization ring.  Relative state
        (T_kf_curr, motion prior, solver init) does not change under the
        correction.  Returns the number of accepted loop edges."""
        from revo_tpu_torch.loopclosure import close_loops

        if len(self.kf_history) < 3:
            return 0
        corrected, loops = close_loops(
            [kf for _, kf in self.kf_history], self.cfg,
            radius=self.cfg.tracker.loop_closure_radius,
        )
        if not loops:
            return 0
        corr = {}
        for i, (o, kf) in enumerate(self.kf_history):
            self.kf_history[i] = (o, kf._replace(T_w_k=self._tensor(corrected[i])))
            corr[o] = corrected[i]
        for node in self.pose_graph:
            if node.kf_ordinal in corr:
                node.T_w_kf = corr[node.kf_ordinal]
        if self.kf_ordinal_current in corr:
            old = _np(self.kf.T_w_k)
            new = corr[self.kf_ordinal_current]
            # The voting floors projections through these poses, so the
            # product rounds as the 4x4 algebra around it (lie.matmul_fma).
            delta = self._tensor((new @ np.linalg.inv(old)).astype(np.float32))
            self.kf = self.kf._replace(T_w_k=self._tensor(new))
            self.past = self.past._replace(poses=lie.matmul_fma(delta, self.past.poses))
            self.past_voting = self.past_voting._replace(
                poses=lie.matmul_fma(delta, self.past_voting.poses)
            )
        if self.reloc_ring is not None:
            Ts = self.reloc_ring.T_w_k.clone()
            for i in range(min(len(self.kf_history), Ts.shape[0])):
                Ts[i] = self.kf_history[-1 - i][1].T_w_k
            self.reloc_ring = self.reloc_ring._replace(T_w_k=Ts)
        return len(loops)

    # -- main entry ----------------------------------------------------------

    def process_frame(self, gray, depth, timestamp: float) -> np.ndarray:
        """Process one frame; returns its estimated world pose (4, 4)."""
        cfg = self.cfg

        if self.n_frames == 0:
            frame = build_frame(
                self._tensor(gray), self._tensor(depth), cfg, self.undistort_maps
            )
            eye4 = np.eye(4, dtype=np.float32)
            self._make_keyframe(frame, eye4)
            node = PoseNode(
                T_kf_curr=eye4.copy(), T_w_kf=eye4.copy(), timestamp=timestamp,
                is_keyframe=True, kf_ordinal=self.kf_ordinal_current,
            )
            self.pose_graph.append(node)
            self._push_past(frame, eye4)
            self.prev_frame = frame
            self.n_frames = 1
            self.just_added_kf = True
            return node.T_w_curr

        t_start = time.perf_counter()
        frame, res, T_kf_n_dev, T_w_curr_dev, new_kf_dev = frame_step(
            self._tensor(gray), self._tensor(depth), self.kf, self.past_voting,
            self.R, self.t, cfg, self.undistort_maps,
        )

        if cfg.tracker.enable_relocalization and (
            self._is_lost(res) or self._is_jump(_np(T_w_curr_dev))
        ):
            ord_r, kf_r, res_r = self._relocalize(frame)
            if kf_r is not None:
                self.kf = kf_r
                self.kf_ordinal_current = ord_r
                self.n_relocalized += 1
                res = res_r
                # Poses against the relocalization anchor; no vote this
                # frame (it was computed against the lost pose).
                T_kf_n_dev = lie.matrix_from_rt(res.R, res.t)
                T_w_curr_dev = lie.matmul_fma(self.kf.T_w_k, T_kf_n_dev)
                new_kf_dev = torch.zeros((), dtype=torch.bool)
            else:
                # Still lost: constant-velocity propagation, no graph decay.
                self.n_tracking_lost += 1
                T_w_prev = self.pose_graph[-1].T_w_curr
                T_w_curr = (T_w_prev @ self.T_nm1_n).astype(np.float32)
                T_w_kf = _np(self.kf.T_w_k)
                node = PoseNode(
                    T_kf_curr=np.linalg.inv(T_w_kf) @ T_w_curr, T_w_kf=T_w_kf,
                    timestamp=timestamp, kf_ordinal=self.kf_ordinal_current,
                )
                self.pose_graph.append(node)
                self.tracking_times.append((time.perf_counter() - t_start) * 1000.0)
                self.prev_frame = frame
                self.n_frames += 1
                self.just_added_kf = False
                return node.T_w_curr

        T_kf_n = _np(T_kf_n_dev)
        T_w_kf = _np(self.kf.T_w_k)
        T_w_curr = _np(T_w_curr_dev)

        with trace.host_read("system.new_kf"):
            new_kf = bool(new_kf_dev)
        if new_kf and not self.just_added_kf:
            # Promote the previous frame to keyframe and re-track
            # (system.cpp:203-241).
            last = self.pose_graph[-1]
            last.promote_to_keyframe()
            self._make_keyframe(self.prev_frame, last.T_w_kf)
            last.kf_ordinal = self.kf_ordinal_current
            # clearUpPastLists (tracker.cpp:248-257): the newest K
            # pre-promotion frames become the voting set until the next
            # promotion.
            self.past_voting = self.past
            R0 = self._tensor(self.T_nm1_n[:3, :3])
            t0 = self._tensor(self.T_nm1_n[:3, 3])
            res = tracker.track_frames(self.kf, frame, R0, t0, cfg)
            T_kf_n = _np(lie.matrix_from_rt(res.R, res.t))
            T_w_kf = _np(self.kf.T_w_k)
            T_w_curr = T_w_kf @ T_kf_n
            # The reference votes again here and discards the result
            # (system.cpp:230); the port skips that dead vote.
            self.just_added_kf = True
        else:
            self.just_added_kf = False
        self.tracking_times.append((time.perf_counter() - t_start) * 1000.0)

        node = PoseNode(
            T_kf_curr=T_kf_n, T_w_kf=T_w_kf, timestamp=timestamp,
            kf_ordinal=self.kf_ordinal_current,
        )
        self.pose_graph.append(node)
        self._push_past(frame, T_w_curr)

        # Motion prior for the next frame (system.cpp:267-271).
        prev_node = self.pose_graph[-2]
        self.T_nm1_n = (np.linalg.inv(prev_node.T_w_curr) @ node.T_w_curr).astype(np.float32)
        T_init = node.T_kf_curr @ self.T_nm1_n
        if cfg.init_from_last_pose:
            self.R = self._tensor(np.ascontiguousarray(T_init[:3, :3], np.float32))
            self.t = self._tensor(np.ascontiguousarray(T_init[:3, 3], np.float32))
        else:
            self.R = torch.eye(3, device=self.device)
            self.t = torch.zeros(3, device=self.device)

        self.prev_frame = frame
        self.n_frames += 1
        if cfg.tracker.online_loop_closure and (
            self.just_added_kf  # promotion: a revisit just became closable
            or self.n_frames % cfg.tracker.loop_closure_every == 0
        ):
            # node.T_w_curr below re-derives from the corrected anchor.
            self._online_loop_closure()
        return node.T_w_curr

    def run(self, frames, pose_file: Optional[str] = None, viewer=None):
        """Run over an iterable of (gray, depth, timestamp); returns (poses
        (N, 4, 4), timestamps, VOReport) and writes ``pose_file`` in TUM
        format when given (and cfg.do_output_poses).  ``viewer`` is an
        optional live visualizer (viz.live.LiveViewer) handed a snapshot per
        frame, the non-blocking equivalent of the reference's viewer-thread
        hand-off (system.cpp:279-281); it changes no pose."""
        poses, stamps = [], []
        for gray, depth, ts in frames:
            poses.append(self.process_frame(gray, depth, ts))
            stamps.append(ts)
            if viewer is not None:
                viewer.update(self, self.prev_frame, poses[-1], len(poses) - 1)
        poses = np.stack(poses) if poses else np.zeros((0, 4, 4))
        if pose_file and self.cfg.do_output_poses:
            R = torch.from_numpy(np.ascontiguousarray(poses[:, :3, :3], np.float32))
            qs = lie.quaternion_from_matrix(R).numpy()
            write_tum_trajectory(pose_file, stamps, poses[:, :3, 3], qs)
        return poses, np.array(stamps), self.report()

    def report(self) -> VOReport:
        lat = (
            np.percentile(self.tracking_times, [50.0, 95.0, 99.0])
            if self.tracking_times
            else np.zeros(3)
        )
        return VOReport(
            frames_tracked=len(self.pose_graph),
            keyframes=self.n_keyframes,
            tracking_lost=self.n_tracking_lost,
            mean_dt_time_ms=float(np.mean(self.keyframe_ms())) if self.dt_times else 0.0,
            mean_tracking_time_ms=float(np.mean(self.tracking_times))
            if self.tracking_times
            else 0.0,
            latency_ms_p50=float(lat[0]),
            latency_ms_p95=float(lat[1]),
            latency_ms_p99=float(lat[2]),
        )
