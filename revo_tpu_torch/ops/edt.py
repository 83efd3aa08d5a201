"""Exact Euclidean distance transform and the keyframe structures
(counterpart of revo_tpu/ops/edt.py).

``distance_transform`` matches cv::distanceTransform(255 - edges, DIST_L2,
DIST_MASK_PRECISE) (imgpyramidrgbd.cpp:241).  It is the JAX module's
banded algorithm written with torch ops:

1. column pass: nearest-edge distance down each column by log-doubling
   min-plus relaxations;
2. chamfer bound B(x) = min_j (|x - j| + g(j)) along rows, by the same
   doubling; the winning source of every pixel lies within R = ceil(max B);
3. row pass: D(x) = min_i ((x - i)^2 + g(i)^2) over offsets |x - i| <= R.

Every squared distance below the 1e9 sentinel is an exact float32 integer
and sqrt rounds correctly, so the result is bit-equal to any exact EDT.  R
is read on the host (one sync per level per keyframe).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_BIG = 1e9


def _shift_fill(d: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """out[i] = d[i - s] along ``dim`` (s may be negative), _BIG outside."""
    n = d.shape[dim]
    out = torch.full_like(d, _BIG)
    if abs(s) >= n:
        return out
    if s > 0:
        out.narrow(dim, s, n - s).copy_(d.narrow(dim, 0, n - s))
    else:
        out.narrow(dim, 0, n + s).copy_(d.narrow(dim, -s, n + s))
    return out


def _column_distances(edges: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> vertical distance to the nearest edge in the
    column (float32), _BIG where the column has none."""
    h = edges.shape[-2]
    init = torch.where(edges, 0.0, _BIG).to(torch.float32)

    def direction(d, sign):
        s = 1
        while s < h:
            d = torch.minimum(d, _shift_fill(d, sign * s, -2) + s)
            s *= 2
        return d

    return torch.minimum(direction(init, 1), direction(init, -1))


def _row_linear_bound(g: torch.Tensor) -> torch.Tensor:
    """B = min_j (|x - j| + g(..., j)) along the last axis (doubling)."""
    w = g.shape[-1]
    d = g
    s = 1
    while s < w:
        left = _shift_fill(d, s, -1)
        right = _shift_fill(d, -s, -1)
        d = torch.minimum(d, torch.minimum(left, right) + s)
        s *= 2
    return d


def _row_edt_sq(gsq: torch.Tensor, r: int) -> torch.Tensor:
    """Exact 1-D squared EDT along rows over offsets 1..r (each side)."""
    w = gsq.shape[-1]
    padded = F.pad(gsq, (r, r), value=_BIG)
    acc = gsq
    for o in range(1, r + 1):
        o2 = float(o * o)
        acc = torch.minimum(acc, padded[..., r - o:r - o + w] + o2)
        acc = torch.minimum(acc, padded[..., r + o:r + o + w] + o2)
    return acc


def distance_transform_batched(edges: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) float32 exact EDT (0 on edges; about
    sqrt(1e9) where an image has no edges), one band radius per batch."""
    w = edges.shape[-1]
    g = _column_distances(edges)
    bound = torch.clamp(_row_linear_bound(g), max=_BIG)
    r = min(int(math.ceil(float(bound.max()))), w)
    gsq = torch.clamp(g * g, max=_BIG)
    return torch.sqrt(_row_edt_sq(gsq, r))


def distance_transform(edges: torch.Tensor) -> torch.Tensor:
    """(H, W) bool -> (H, W) float32 exact Euclidean distance to the
    nearest edge pixel."""
    return distance_transform_batched(edges[None])[0]


def _edge_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., clamp(y + dy), clamp(x + dx)] over the last
    two axes."""
    h, w = x.shape[-2], x.shape[-1]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[..., ys, :][..., xs]


def build_optimization_structure(dt: torch.Tensor) -> torch.Tensor:
    """(..., H, W) distance transform -> (..., H, W, 3) (gx, gy, dt):
    negated central differences with clamped borders
    (imgpyramidrgbd.cpp:255-276)."""
    gx = 0.5 * (_edge_shift(dt, 0, -1) - _edge_shift(dt, 0, 1))
    gy = 0.5 * (_edge_shift(dt, -1, 0) - _edge_shift(dt, 1, 0))
    return torch.stack([gx, gy, dt], dim=-1)


def keyframe_structure(edges: torch.Tensor) -> torch.Tensor:
    """Fused DT + gradients: the per-level keyframe tensor (makeKeyframe,
    imgpyramidrgbd.cpp:231-252), for (..., H, W) edges (lanes on the
    leading axes).  The lanes take one band radius, the largest of theirs;
    a wider band only adds candidates that lose to each pixel's own
    minimum, so every lane gets the bits it gets alone."""
    dt = distance_transform_batched(edges.reshape(-1, *edges.shape[-2:]))
    return build_optimization_structure(dt.reshape(edges.shape))


def quad_structure(struct: torch.Tensor, form: str = "dt4bf") -> torch.Tensor:
    """(..., H, W, 3) structure -> (..., H*W, 4) dt-only 2x2 tap table
    [dt(y, x), dt(y, x+1), dt(y+1, x), dt(y+1, x+1)] with edge-padded last
    row/column; "dt4bf" stores it in bfloat16 (round to nearest even, as
    XLA), "dt4" in float32.  The solver upcasts after the gather."""
    if form not in ("dt4", "dt4bf"):
        raise ValueError(f"quad form {form!r} is not ported; use 'dt4' or 'dt4bf'")
    dt = struct[..., 2]
    q = torch.stack(
        [dt, _edge_shift(dt, 0, 1), _edge_shift(dt, 1, 0), _edge_shift(dt, 1, 1)],
        dim=-1,
    ).reshape(*dt.shape[:-2], -1, 4)
    return q.to(torch.bfloat16) if form == "dt4bf" else q.contiguous()
