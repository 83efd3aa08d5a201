"""Exact Euclidean distance transform and the keyframe structures
(counterpart of revo_tpu/ops/edt.py).

``distance_transform`` matches cv::distanceTransform(255 - edges, DIST_L2,
DIST_MASK_PRECISE) (imgpyramidrgbd.cpp:241).  The plain version is the JAX
module's banded algorithm written with torch ops:

1. column pass: nearest-edge distance down each column by log-doubling
   min-plus relaxations;
2. chamfer bound B(x) = min_j (|x - j| + g(j)) along rows, by the same
   doubling; the winning source of every pixel lies within R = ceil(max B);
3. row pass: D(x) = min_i ((x - i)^2 + g(i)^2) over offsets |x - i| <= R.

Every squared distance below the 1e9 sentinel is an exact float32 integer
and ``project.sqrt_rn`` rounds its square root correctly (PyTorch's CPU
sqrt does not), so the result is bit-equal to any exact EDT.  The plain
version reads R on the host (one sync a level).

``keyframe_tables`` is what ``make_keyframe`` calls: the structure and the
quad table of every level.  CPU tensors take ``keyframe_tables_ref`` a
level (the code above, then ``build_optimization_structure`` and
``quad_structure``); CUDA tensors two hand kernels (csrc/frontend.cu):
``edt_columns_levels`` (g^2 of every level in one launch, from bit-packed
column words) and ``keyframe_rows`` a level (each row's exact squared EDT by
a search that stops once the offset's square reaches the best so far, the
root, the structure and the quad table), with no band radius and no host
read; each has its plain version beside it (``edt_columns_ref``,
``keyframe_rows_ref``) and counts its launches in ``launches``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from revo_tpu_torch import kernels
from revo_tpu_torch.ops.project import sqrt_rn

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
    return sqrt_rn(_row_edt_sq(gsq, r))


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


# Quad forms (OptimizerConfig.quad_form) -> (row width, dtype) of the port's
# table.  The JAX package's 12-component forms differ only in the storage
# layout its TPU gather preferred ("hw12" (H, W, 12), "flat" (H*W, 12), "t"
# (12, H*W), "flat16" (H*W, 16) with a pad lane a tap); the port holds every
# one as the same (H*W, 12) rows, which ``convert`` maps them onto.
QUAD_FORMS = {
    "hw12": (12, torch.float32),
    "flat": (12, torch.float32),
    "t": (12, torch.float32),
    "flat16": (12, torch.float32),
    "flatbf": (12, torch.bfloat16),
    "dt4": (4, torch.float32),
    "dt4bf": (4, torch.bfloat16),
}


def quad_structure(struct: torch.Tensor, form: str = "dt4bf") -> torch.Tensor:
    """(..., H, W, 3) structure -> (..., H*W, C) packed 2x2-neighbourhood
    table (revo_tpu/ops/edt.py ``quad_structure``): row (y, x) holds the
    taps [S(y, x), S(y, x+1), S(y+1, x), S(y+1, x+1)] with edge-padded last
    row and column, so the solver's sample gathers one row.  "dt4" / "dt4bf"
    keep only the dt channel (C = 4; the solver differentiates the bilinear
    dt surface); the other forms keep (gx, gy, dt) a tap, tap-major and
    channel-minor (C = 12; the reference's interpolated central
    differences).  "dt4bf" and "flatbf" store bfloat16 (round to nearest
    even, as XLA), the others float32.  The solver upcasts after the
    gather."""
    if form not in QUAD_FORMS:
        raise ValueError(f"unknown quad form {form!r}; one of {sorted(QUAD_FORMS)}")
    width, dtype = QUAD_FORMS[form]
    planes = struct[..., 2:3] if width == 4 else struct
    planes = planes.movedim(-1, -3)  # (..., C, H, W): shift over the last two axes
    taps = [planes, _edge_shift(planes, 0, 1), _edge_shift(planes, 1, 0),
            _edge_shift(planes, 1, 1)]
    q = torch.cat([tap.movedim(-3, -1) for tap in taps], dim=-1)
    return q.reshape(*q.shape[:-3], -1, width).to(dtype).contiguous()


def edt_columns_ref(edges: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) float32 g^2, g the vertical distance to
    the nearest edge of the column (1e9 where the column has none), g^2
    clamped to 1e9: the plain version of ``edt_columns``."""
    g = _column_distances(edges)
    return torch.clamp(g * g, max=_BIG)


def keyframe_rows_ref(g2: torch.Tensor, form: str):
    """(B, H, W) float32 g^2 -> (structure (B, H, W, 3), quad table (B, H*W,
    C) of ``form``): the plain version of ``keyframe_rows``.  The row pass
    runs over every offset of the row (R = W): any exact search returns the
    same float32 minimum."""
    dt = sqrt_rn(_row_edt_sq(g2, g2.shape[-1]))
    struct = build_optimization_structure(dt)
    return struct, quad_structure(struct, form)


def keyframe_tables_ref(edges: torch.Tensor, form: str):
    """(..., H, W) bool -> (structure (..., H, W, 3), quad table (..., H*W,
    C)): ``keyframe_structure`` and ``quad_structure``, the plain version of
    ``keyframe_tables``."""
    struct = keyframe_structure(edges)
    return struct, quad_structure(struct, form)


def _check_card(x: torch.Tensor, dtype, name: str) -> bool:
    """A kernel wrapper's route for (B, H, W) ``x``: False on the CPU, True
    on the card (contiguous ``dtype`` wanted there); raises otherwise."""
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"{name}: want a non-empty (B, H, W) tensor, got {tuple(x.shape)}")
    if not kernels.on_card(name, x):
        return False
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype}, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    return True


EDT_MAX_LEVELS = 8  # levels a launch of revo_edt_columns_levels (csrc/frontend.cu)


def edt_columns_levels(levels):
    """A sequence of (B, H, W) bool edges, one a level (B the same, H and W
    the level's) -> their (B, H, W) float32 g^2, each bit-equal to
    ``edt_columns_ref``.  CUDA tensors: ``revo_edt_columns_levels``, one
    launch for every level and lane (EDT_MAX_LEVELS levels a launch): a
    cluster of 8 blocks a strip of 64 columns, each block a chunk of rows
    packed into column words, the chunks' first and last edges traded over
    DSMEM."""
    levels = list(levels)
    if not levels:
        raise ValueError("edt_columns_levels: want at least one level")
    card = kernels.on_card("edt_columns_levels", *levels)  # raises for a mix of devices
    if not all([_check_card(e, torch.bool, "edt_columns_levels") for e in levels]) or not card:
        return [edt_columns_ref(e) for e in levels]
    b = levels[0].shape[0]
    if any(e.shape[0] != b for e in levels):
        raise ValueError(f"edt_columns_levels: want one B, got {[tuple(e.shape) for e in levels]}")
    g2s = [torch.empty(e.shape, dtype=torch.float32, device=e.device) for e in levels]
    for k in range(0, len(levels), EDT_MAX_LEVELS):
        group = range(k, min(k + EDT_MAX_LEVELS, len(levels)))
        table = [v for i in group for v in (levels[i].data_ptr(), g2s[i].data_ptr(),
                                            *levels[i].shape[1:])]
        kernels.launch("revo_edt_columns_levels", table, len(group), b, device=levels[0].device)
        edt_columns_levels.launches += 1
    return g2s


edt_columns_levels.launches = 0


def keyframe_rows(g2: torch.Tensor, form: str):
    """(B, H, W) float32 g^2 -> (structure (B, H, W, 3) float32, quad table
    (B, H*W, C) of ``form``), bit-equal to ``keyframe_rows_ref``.  CUDA
    tensor: ``revo_keyframe_rows``, one launch for all B lanes, a block a
    band of rows and a cluster a run of bands whose halo rows the blocks
    trade over DSMEM (their sizes follow the lanes and the shape; the bits
    do not depend on them); rows up to 11,622 wide; no band radius and no
    host read."""
    if form not in QUAD_FORMS:
        raise ValueError(f"unknown quad form {form!r}; one of {sorted(QUAD_FORMS)}")
    if not _check_card(g2, torch.float32, "keyframe_rows"):
        return keyframe_rows_ref(g2, form)
    b, h, w = g2.shape
    width, dtype = QUAD_FORMS[form]
    struct = torch.empty((b, h, w, 3), dtype=torch.float32, device=g2.device)
    quad = torch.empty((b, h * w, width), dtype=dtype, device=g2.device)
    kernels.launch("revo_keyframe_rows", g2, struct, quad, b, h, w, width,
                   int(dtype == torch.bfloat16))
    keyframe_rows.launches += 1
    return struct, quad


keyframe_rows.launches = 0


def keyframe_tables(levels, form: str):
    """A sequence of (..., H, W) bool edges, one a level (lanes on the same
    leading axes) -> a list of (structure (..., H, W, 3), quad table (...,
    H*W, C) of ``form``), one a level.  CPU tensors: ``keyframe_tables_ref``
    a level; CUDA tensors: ``edt_columns_levels`` once, then
    ``keyframe_rows`` a level, 1 + levels launches for all lanes, bit-equal
    to it."""
    levels = list(levels)
    if not kernels.on_card("keyframe_tables", *levels):
        return [keyframe_tables_ref(e, form) for e in levels]
    lead = levels[0].shape[:-2]
    g2s = edt_columns_levels([e.reshape(-1, *e.shape[-2:]).contiguous() for e in levels])
    out = []
    for e, g2 in zip(levels, g2s):
        h, w = e.shape[-2:]
        struct, quad = keyframe_rows(g2, form)
        out.append((struct.reshape(*lead, h, w, 3), quad.reshape(*lead, h * w, quad.shape[-1])))
    return out
