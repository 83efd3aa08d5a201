"""Keyframe loop closure: detect revisits, verify them with the DT tracker,
correct with pose-graph GN (counterpart of revo_tpu/loopclosure.py).

REVO is odometry-only (tracker.h:63); this adds the SLAM step on top of
what the port already has: the keyframe history (system.py), the pairwise
DT tracker as geometric verifier (``tracker.track_frames``) and the
pose-graph optimizer (parallel/posegraph.py).

1. Candidates: keyframe pairs (a, b), b - a > min_separation, whose
   estimated positions lie within ``radius`` metres (host numpy).
2. Verification: track keyframe b's frame against keyframe a's DT structure
   from the current relative estimate; accept on low mean error, enough
   inliers and a healthy good/bad ratio.  It reads only a keyframe's
   structs, quads and clouds, so pruned keyframes
   (``frontend.prune_keyframe``) verify like whole ones.
3. Correction: odometry edges between consecutive keyframes plus the
   accepted loop edges go through pose-graph GN; every frame re-anchors
   rigidly to its corrected parent keyframe (T_w_kf @ T_kf_curr,
   system.h:130-133).

Tracking and the pose graph run on the device the keyframes live on; poses
enter and leave as numpy arrays, as in the JAX module.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from revo_tpu_torch import tracker
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.frontend import Keyframe
from revo_tpu_torch.parallel.mesh import gather, local_slots, shard, to_device
from revo_tpu_torch.parallel.posegraph import PoseGraphEdges, optimize_pose_graph


class LoopEdge(NamedTuple):
    a: int  # earlier keyframe ordinal
    b: int  # later keyframe ordinal
    T_ab: np.ndarray  # (4, 4) verified relative pose (frame b in kf a)
    error: float  # tracker mean weighted DT error


def _pose(kf: Keyframe) -> np.ndarray:
    return kf.T_w_k.detach().cpu().numpy().astype(np.float32)


def find_candidates(
    kf_poses: Sequence[np.ndarray],
    min_separation: int = 2,
    radius: float = 0.5,
    max_candidates: int = 20,
) -> List[Tuple[int, int]]:
    """Keyframe pairs whose estimated positions are within ``radius`` m and
    more than ``min_separation`` keyframes apart (most distant in time
    first, capped)."""
    if len(kf_poses) < 2:
        return []
    P = np.stack([np.asarray(T)[:3, 3] for T in kf_poses])
    D = np.linalg.norm(P[None, :] - P[:, None], axis=-1)  # (K, K) a-major
    k = len(kf_poses)
    sep = np.arange(k)[None, :] - np.arange(k)[:, None]  # b - a
    a_idx, b_idx = np.nonzero((D < radius) & (sep > min_separation))
    out = sorted(
        ((int(b - a), int(a), int(b)) for a, b in zip(a_idx, b_idx)), reverse=True
    )
    return [(a, b) for _, a, b in out[:max_candidates]]


def verify_candidate(
    kf_a: Keyframe,
    kf_b: Keyframe,
    cfg: SystemConfig,
    max_error: float = 0.3,
    min_good_ratio: float = 2.0,
    min_good: int = 300,
) -> Optional[Tuple[np.ndarray, float]]:
    """Geometric verification: track b's frame against a's DT structure
    from the current relative estimate.  Returns (T_ab, error) or None.

    The good/bad gate is looser than the tracker's promotion ratio (4.0,
    tracker.cpp:351): loop pairs sit across wider baselines where partial
    overlap is legitimate, so precision comes from the DT error bound plus
    an absolute inlier count, the ratio only guarding degenerate overlaps."""
    T_ab0 = (np.linalg.inv(_pose(kf_a)) @ _pose(kf_b)).astype(np.float32)
    dev = kf_a.T_w_k.device
    res = tracker.track_frames(
        kf_a, kf_b.frame,
        torch.from_numpy(np.ascontiguousarray(T_ab0[:3, :3])).to(dev),
        torch.from_numpy(np.ascontiguousarray(T_ab0[:3, 3])).to(dev),
        cfg,
    )
    err = float(res.error)
    good = int(res.good)
    bad = max(int(res.bad), 1)
    if err > max_error or good < min_good or good / bad < min_good_ratio:
        return None
    T_ab = np.eye(4, dtype=np.float32)
    T_ab[:3, :3] = res.R.detach().cpu().numpy()
    T_ab[:3, 3] = res.t.detach().cpu().numpy()
    return T_ab, err


def verify_candidates_batched(
    keyframes: Sequence[Keyframe],
    cands: Sequence[Tuple[int, int]],
    cfg: SystemConfig,
    max_error: float = 0.3,
    min_good_ratio: float = 2.0,
    min_good: int = 300,
    mesh=None,
    axis: str = "cand",
) -> List[Optional[Tuple[np.ndarray, float]]]:
    """Verify all candidate pairs; one entry per candidate, ``(T_ab,
    error)`` or ``None``, what ``verify_candidate`` returns for each.  JAX
    runs the pairs as one vmapped dispatch; here they are tracked one after
    the other, as ``tracker.track_ring`` tracks its slots.  With ``mesh``
    the candidates, padded to a multiple of the axis size with copies of
    candidate 0, are sharded over ``axis``: each slot verifies its share
    with the two keyframes of each pair on its device, and the verdicts
    are gathered in order, the padding dropped."""
    def verify(pairs, kfs):
        return [verify_candidate(kfs(a), kfs(b), cfg, max_error, min_good_ratio, min_good)
                for a, b in pairs]

    if mesh is None or not cands:
        return verify(cands, keyframes.__getitem__)
    slots = local_slots(mesh, axis)
    cands = list(cands)
    padded = cands + cands[:1] * ((-len(cands)) % mesh.shape[axis])
    verdicts = gather([
        verify(pairs, lambda k, dev=dev: to_device(keyframes[k], dev))
        for pairs, dev in zip(shard(padded, mesh, axis), slots)
    ], mesh, axis)
    return verdicts[:len(cands)]


def close_loops(
    keyframes: Sequence[Keyframe],
    cfg: SystemConfig,
    min_separation: int = 2,
    radius: float = 0.5,
    max_error: float = 0.3,
    loop_weight: float = 2.0,
    iters: int = 15,
) -> Tuple[np.ndarray, List[LoopEdge]]:
    """Detect + verify + correct over a keyframe list.  Returns (corrected
    keyframe world poses (K, 4, 4), accepted loop edges); with no accepted
    edge the input poses come back unchanged."""
    kf_T = [_pose(k) for k in keyframes]
    k = len(kf_T)
    cands = find_candidates(kf_T, min_separation, radius)
    verdicts = verify_candidates_batched(keyframes, cands, cfg, max_error=max_error)
    loops = [
        LoopEdge(a=a, b=b, T_ab=v[0], error=v[1])
        for (a, b), v in zip(cands, verdicts) if v is not None
    ]
    poses0 = np.stack(kf_T) if kf_T else np.zeros((0, 4, 4), np.float32)
    if not loops or k < 2:
        return poses0, loops

    # Odometry edges from the current estimates (consecutive keyframes),
    # then the verified loop edges.
    ei = list(range(k - 1)) + [e.a for e in loops]
    ej = list(range(1, k)) + [e.b for e in loops]
    em = [np.linalg.inv(kf_T[i]) @ kf_T[i + 1] for i in range(k - 1)] + [e.T_ab for e in loops]
    ew = [1.0] * (k - 1) + [loop_weight] * len(loops)
    dev = keyframes[0].T_w_k.device
    edges = PoseGraphEdges(
        i=torch.tensor(ei, dtype=torch.int32, device=dev),
        j=torch.tensor(ej, dtype=torch.int32, device=dev),
        T_meas=torch.from_numpy(np.stack(em).astype(np.float32)).to(dev),
        weight=torch.tensor(ew, dtype=torch.float32, device=dev),
    )
    corrected = optimize_pose_graph(torch.from_numpy(poses0).to(dev), edges, iters=iters)
    return corrected.cpu().numpy(), loops


def reanchor_trajectory(pose_graph, corrected_kf_poses: np.ndarray) -> np.ndarray:
    """Re-anchor every frame of a VOSystem pose graph to its corrected
    parent keyframe: T_w_curr = T_w_kf(corrected) @ T_kf_curr
    (system.h:130-133).  ``pose_graph`` is the list of PoseNode records
    (each carries ``kf_ordinal``)."""
    return np.stack(
        [corrected_kf_poses[node.kf_ordinal] @ node.T_kf_curr for node in pose_graph]
    )
