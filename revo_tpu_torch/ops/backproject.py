"""Edge back-projection into fixed-capacity 3-D clouds (counterpart of
revo_tpu/ops/backproject.py).

Every edge pixel with depth in (depth_min, depth_max) becomes the camera-
frame point (Z (x - cx) / fx, Z (y - cy) / fy, Z) (addLevelEdge,
imgpyramidrgbd.cpp:199-226).  The cloud has a fixed capacity: points fill
the first ``count`` slots in ascending pixel order; when more pixels
qualify than fit, slot = floor(pos * capacity / count) in float32 and the
highest pos wins a shared slot (a uniform stride decimation).  This is the
JAX module's scatter form (``_compact_scatter``), bit-identical to its
default rank-sort compaction.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EdgeCloud(NamedTuple):
    """Fixed-capacity edge point cloud of one pyramid level."""

    points: torch.Tensor  # (P, 3) float32 camera-frame points, 0 on dead lanes
    valid: torch.Tensor  # (P,) bool
    count: torch.Tensor  # () int32 qualifying pixels (may exceed P)


def compact(valid_px: torch.Tensor, capacity: int):
    """(H, W) bool -> (idx (capacity,) int64 flat pixel index, lane_valid
    (capacity,) bool, count () int32)."""
    flat = valid_px.reshape(-1)
    n = flat.shape[0]
    pos = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32) - 1
    count = pos[-1] + 1
    over = count > capacity
    cmax = torch.clamp(count, min=capacity).to(torch.float32)
    scale = torch.full_like(cmax, float(capacity)) / cmax
    slot = torch.where(
        over, torch.floor(pos.to(torch.float32) * scale).to(torch.int32), pos
    )
    tgt = torch.where(flat & (slot < capacity), slot, capacity).to(torch.int64)
    src = torch.arange(1, n + 1, dtype=torch.int64, device=flat.device)
    idxp = torch.zeros(capacity + 1, dtype=torch.int64, device=flat.device)
    idxp = idxp.scatter_reduce(0, tgt, src, reduce="amax")[:capacity]
    lane_valid = idxp > 0
    idx = torch.clamp(idxp - 1, min=0)
    return idx, lane_valid, count


def backproject_edges(
    edges: torch.Tensor,
    depth: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    depth_min: float,
    depth_max: float,
    capacity: int,
) -> EdgeCloud:
    """Edge pixels with finite depth strictly inside (depth_min, depth_max)
    -> EdgeCloud (isPointOkEdgePyr, imgpyramidrgbd.h:176-180)."""
    h, w = edges.shape
    valid_px = (
        edges & torch.isfinite(depth) & (depth > depth_min) & (depth < depth_max)
    )
    idx, lane_valid, count = compact(valid_px, capacity)
    z = depth.reshape(-1)[idx]
    yy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xx = (idx % w).to(torch.float32)
    # Division by the focal length as a multiply by its float32 reciprocal:
    # what XLA and PyTorch's CUDA division by a scalar both compute.
    inv_fx = float(np.float32(1.0 / np.float32(fx)))
    inv_fy = float(np.float32(1.0 / np.float32(fy)))
    pts = torch.stack([z * (xx - cx) * inv_fx, z * (yy - cy) * inv_fy, z], dim=-1)
    pts = torch.where(lane_valid[:, None], pts, 0.0)
    return EdgeCloud(points=pts, valid=lane_valid, count=count)
