"""Edge back-projection into fixed-capacity 3-D clouds (counterpart of
revo_tpu/ops/backproject.py).

Every edge pixel with depth in (depth_min, depth_max) becomes the camera-
frame point (Z (x - cx) / fx, Z (y - cy) / fy, Z) (addLevelEdge,
imgpyramidrgbd.cpp:199-226).  The cloud has a fixed capacity: points fill
the first ``count`` slots in ascending pixel order; when more pixels
qualify than fit, slot = floor(pos * capacity / count) in float32 and the
highest pos wins a shared slot (a uniform stride decimation).  The plain
version (``backproject_edges_ref``) is the JAX module's scatter form
(``_compact_scatter``), bit-identical to its default rank-sort compaction.
``backproject_edges`` takes it for a CPU tensor; a CUDA tensor takes the
hand kernel ``revo_edge_cloud`` (csrc/frontend.cu: one launch, a thread-block
cluster a lane whose blocks scan their pixels into shared memory, trade
counts over DSMEM and write their slots with coalesced stores; no atomics,
no scratch, no host read), counted in ``backproject_edges.launches``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from revo_tpu_torch import kernels


class EdgeCloud(NamedTuple):
    """Fixed-capacity edge point cloud of one pyramid level (a leading lane
    axis on every field in a batched frame)."""

    points: torch.Tensor  # (P, 3) float32 camera-frame points, 0 on dead lanes
    valid: torch.Tensor  # (P,) bool
    count: torch.Tensor  # () int32 qualifying pixels (may exceed P)


def compact(valid_px: torch.Tensor, capacity: int):
    """(..., H, W) bool -> (idx (..., capacity) int64 flat pixel index,
    lane_valid (..., capacity) bool, count (...) int32).  Each image on the
    leading axes is compacted on its own: a cumsum over its flat pixels,
    then one scatter whose targets are offset by image x (capacity + 1), so
    its slots are those it gets alone."""
    lead = valid_px.shape[:-2]
    flat = valid_px.reshape(-1, valid_px.shape[-2] * valid_px.shape[-1])
    b, n = flat.shape
    pos = torch.cumsum(flat.to(torch.int32), -1, dtype=torch.int32) - 1
    count = pos[:, -1] + 1
    over = count > capacity
    cmax = torch.clamp(count, min=capacity).to(torch.float32)
    scale = torch.full_like(cmax, float(capacity)) / cmax
    slot = torch.where(
        over[:, None], torch.floor(pos.to(torch.float32) * scale[:, None]).to(torch.int32), pos
    )
    tgt = torch.where(flat & (slot < capacity), slot, capacity).to(torch.int64)
    tgt = tgt + (capacity + 1) * torch.arange(b, device=flat.device)[:, None]
    src = torch.arange(1, n + 1, dtype=torch.int64, device=flat.device).expand(b, n)
    idxp = torch.zeros(b * (capacity + 1), dtype=torch.int64, device=flat.device)
    idxp = idxp.scatter_reduce(0, tgt.reshape(-1), src.reshape(-1), reduce="amax")
    idxp = idxp.reshape(b, capacity + 1)[:, :capacity]
    lane_valid = idxp > 0
    idx = torch.clamp(idxp - 1, min=0)
    return (idx.reshape(*lead, capacity), lane_valid.reshape(*lead, capacity),
            count.reshape(lead))


def _inv_focal(f: float) -> float:
    return float(np.float32(1.0 / np.float32(f)))


def backproject_edges_ref(
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
    -> EdgeCloud (isPointOkEdgePyr, imgpyramidrgbd.h:176-180), for
    (..., H, W) edges and depth (lanes on the leading axes): the plain
    version of ``backproject_edges``."""
    w = edges.shape[-1]
    valid_px = (
        edges & torch.isfinite(depth) & (depth > depth_min) & (depth < depth_max)
    )
    idx, lane_valid, count = compact(valid_px, capacity)
    z = torch.gather(depth.reshape(*depth.shape[:-2], -1), -1, idx)
    yy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xx = (idx % w).to(torch.float32)
    # Division by the focal length as a multiply by its float32 reciprocal:
    # what XLA and PyTorch's CUDA division by a scalar both compute.
    inv_fx, inv_fy = _inv_focal(fx), _inv_focal(fy)
    pts = torch.stack([z * (xx - cx) * inv_fx, z * (yy - cy) * inv_fy, z], dim=-1)
    pts = torch.where(lane_valid[..., None], pts, 0.0)
    return EdgeCloud(points=pts, valid=lane_valid, count=count)


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
    """``backproject_edges_ref``'s EdgeCloud of (..., H, W) bool edges and
    float32 depth, bit-equal to it.  CPU tensors: the plain version; CUDA
    tensors: ``revo_edge_cloud``, one launch for all lanes, a cluster of
    blocks a lane (its size follows the lanes and the shape; the bits do not
    depend on it)."""
    if edges.shape != depth.shape or edges.dim() < 2:
        raise ValueError(f"backproject_edges: edges {tuple(edges.shape)} and depth "
                         f"{tuple(depth.shape)} differ")
    if not kernels.on_card("backproject_edges", edges, depth):
        return backproject_edges_ref(edges, depth, fx, fy, cx, cy, depth_min, depth_max,
                                     capacity)
    if edges.dtype != torch.bool or depth.dtype != torch.float32:
        raise ValueError(f"backproject_edges: want bool edges and float32 depth, got "
                         f"{edges.dtype}, {depth.dtype}")
    if capacity < 1:
        raise ValueError(f"backproject_edges: capacity {capacity}")
    lead, (h, w) = edges.shape[:-2], edges.shape[-2:]
    e = edges.reshape(-1, h, w).contiguous()
    d = depth.reshape(-1, h, w).contiguous()
    b = e.shape[0]
    points = torch.empty((b, capacity, 3), dtype=torch.float32, device=e.device)
    valid = torch.empty((b, capacity), dtype=torch.bool, device=e.device)
    count = torch.empty(b, dtype=torch.int32, device=e.device)
    kernels.launch("revo_edge_cloud", e, d, points, valid, count, b, h, w, _inv_focal(fx),
                   _inv_focal(fy), cx, cy, depth_min, depth_max, capacity)
    backproject_edges.launches += 1
    return EdgeCloud(points=points.reshape(*lead, capacity, 3),
                     valid=valid.reshape(*lead, capacity), count=count.reshape(lead))


backproject_edges.launches = 0
