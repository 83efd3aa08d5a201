"""Segment-parallel tracking of long sequences with overlap stitching
(counterpart of revo_tpu/parallel/segments.py).

A long sequence is split into S segments that overlap by one frame; each
segment is tracked on its own by ``vo_scan``, which anchors it at its first
frame.  Stitching composes the segment anchors by a prefix product over
SE(3); an optional pose-graph relaxation over the consecutive-frame edges
follows.  JAX vmaps the segments (or shards them over a mesh) and takes the
prefix product as an associative scan; here the segments run one after the
other, as ``vo_scan_batched`` runs its sequences (or are sharded over a
mesh as it shards them), and the prefix is a running product, so float32
anchors differ from the scan tree's by ulps.
"""
from __future__ import annotations

from typing import Tuple

import torch

from revo_tpu_torch import lie
from revo_tpu_torch.config import SystemConfig
from revo_tpu_torch.parallel.batch import vo_scan_batched
from revo_tpu_torch.parallel.posegraph import optimize_pose_graph, trajectory_to_edges


def split_segments(
    grays: torch.Tensor, depths: torch.Tensor, n_segments: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) -> (S, L, H, W) with one-frame overlap between segments.

    Segment s covers frames [s*step, s*step + L) where L = step + 1, so
    segment s's last frame is segment s+1's first.  N-1 must be divisible
    by S."""
    n = grays.shape[0]
    if (n - 1) % n_segments != 0:
        raise ValueError(f"need (N-1) % S == 0, got N={n}, S={n_segments}")
    step = (n - 1) // n_segments

    def split(x):  # slices, not an index gather: raw uint16 depth has none on the card
        return torch.stack([x[s * step:s * step + step + 1] for s in range(n_segments)])

    return split(grays), split(depths)


def track_segments(
    seg_grays: torch.Tensor, seg_depths: torch.Tensor, cfg: SystemConfig,
    mesh=None, axis: str = "seq",
) -> torch.Tensor:
    """Track each (S, L, H, W) segment on its own; returns segment-local
    poses (S, L, 4, 4) anchored at identity per segment.  With ``mesh`` the
    segments are sharded over ``axis`` as ``vo_scan_batched`` shards
    sequences (S must divide by its size), bit-equal to the mesh-less
    form."""
    return vo_scan_batched(seg_grays, seg_depths, cfg, mesh=mesh, axis=axis)


def stitch_segments(seg_poses: torch.Tensor) -> torch.Tensor:
    """Compose segment-local trajectories into one global trajectory.

    Segment s's anchor is the composition of all previous segments' end
    poses: A_0 = I, A_{s+1} = A_s @ P_s[-1].  Returns (N, 4, 4) where
    N = S * (L - 1) + 1, each segment's duplicated first frame dropped."""
    anchors = [torch.eye(4, dtype=seg_poses.dtype, device=seg_poses.device)]
    for end in seg_poses[:-1, -1]:
        anchors.append(lie.matmul_fma(anchors[-1], end))
    glob = lie.matmul_fma(torch.stack(anchors)[:, None], seg_poses)  # (S, L, 4, 4)
    return torch.cat([glob[0], glob[1:, 1:].reshape(-1, 4, 4)])


def track_long_sequence(
    grays: torch.Tensor, depths: torch.Tensor, cfg: SystemConfig, n_segments: int,
    mesh=None, refine: bool = False,
) -> torch.Tensor:
    """Segment-parallel VO end to end: split -> track -> stitch (-> optional
    pose-graph relaxation over consecutive-frame edges).  Runs on the device
    of ``grays``, or with ``mesh`` tracks the segments on its "seq" slots
    and stitches on the first slot's device."""
    sg, sd = split_segments(grays, depths, n_segments)
    poses = stitch_segments(track_segments(sg, sd, cfg, mesh=mesh))
    if refine:
        poses = optimize_pose_graph(poses, trajectory_to_edges(poses), iters=5)
    return poses
