"""K3: the LGSX normal-equation reduction (counterpart of
revo_tpu/ops/pallas/lgsx.py::lgsx_reduce), alone and fused with the
residual pass that feeds it.

``lgsx_reduce``: from warped points (P, 3), fx/fy-scaled DT gradients
(P, 2), residuals (P,) and weights (P,) (0 on dead lanes) form each point's
6-dof Jacobian row (optimizer.cpp:216-228) and reduce A = sum w J J^T,
g = sum w J r and s = sum w r^2, unnormalized (the caller divides by the
good count).  This is the TPU kernel's own contract.

``residual_lgsx`` is one evaluation of the solver (``solver.residual_system``;
on the card a level runs the same pass inside its level kernel,
csrc/level.cu, and the two-launch loop calls this once per evaluation): the whole
residual pass (``residual_terms``: transform, project, bounds-check, sample
the keyframe level's table, edge filter, Huber weight) and that reduction,
plus the unweighted error sum and the good and bad counts, in one kernel
launch that reads the pose from device memory and needs no host sync.  The
table is any of the three the JAX solver samples (``table_layout``): the
dt-only quad table ("dt4" / "dt4bf", gradients of the bilinear dt
surface), the 12-component quad table (the other quad forms, "flatbf" in
bfloat16) or the (H, W, 3) structure itself as (H*W, 3) rows (a
``bilinear_impl`` that is not "quad*"); the last two interpolate the
reference's central differences.
``residual_lgsx_batched`` is the same over B lanes in one launch (the JAX
package vmaps the solver); ``residual_lgsx`` is its B = 1 case.  A solver
level checks its cloud and table once (``lane_operands``) and launches
with each evaluation's pose (``residual_lgsx_lanes``).

Each has a plain PyTorch version beside it (``lgsx_reduce_ref``, the JAX
solver's einsum path, solver.py:264-281; ``residual_lgsx_ref``).  A wrapper
runs the plain version for a CPU tensor and its CUDA kernel
(revo_tpu_torch/csrc/lgsx.cu) for a tensor on the card, and raises for any
other device; ``launches`` on each wrapper counts its kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from revo_tpu_torch import kernels
from revo_tpu_torch.config import CameraConfig
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.ops.interp import sample_table
from revo_tpu_torch.ops.project import apply_rt_cols, scale_shift


def jacobian(wxp: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """(P, 3) warped points, (P, 2) scaled gradients -> (P, 6) J rows."""
    px, py, pz = wxp[:, 0], wxp[:, 1], wxp[:, 2]
    gx, gy = grads[:, 0], grads[:, 1]
    pz_safe = torch.where(pz == 0, 1e-12, pz)
    iz = 1.0 / pz_safe
    iz2 = iz * iz
    return torch.stack(
        [
            iz * gx,
            iz * gy,
            (-px * iz2) * gx + (-py * iz2) * gy,
            (-px * py * iz2) * gx - (1.0 + py * py * iz2) * gy,
            (1.0 + px * px * iz2) * gx + (px * py * iz2) * gy,
            (-py * iz) * gx + (px * iz) * gy,
        ],
        dim=-1,
    )


def lgsx_reduce_ref(wxp, grads, r, w):
    """Plain K3: (A (6, 6), g (6,), s ()) as float32 einsums."""
    J = jacobian(wxp, grads)
    A = torch.einsum("pi,pj->ij", J * w[:, None], J)
    g = torch.einsum("pi,p->i", J, w * r)
    s = torch.sum(w * r * r)
    return A, g, s


def lgsx_reduce(wxp, grads, r, w):
    """K3 wrapper.  CPU tensors: plain version; CUDA tensors: the kernel,
    two points a thread over ``reduce_blocks(P)`` blocks of 128 threads,
    partial rows summed in block order by the last block (no float atomics:
    two launches on the same inputs give the same bits)."""
    if wxp.device.type == "cpu":
        return lgsx_reduce_ref(wxp, grads, r, w)
    if wxp.device.type != "cuda":
        raise ValueError(f"lgsx_reduce: unsupported device {wxp.device}")
    p = wxp.shape[0]
    shapes = ((wxp, (p, 3)), (grads, (p, 2)), (r, (p,)), (w, (p,)))
    for x, shape in shapes:
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != wxp.device:
            raise ValueError(
                f"lgsx_reduce: want float32 {shape} on {wxp.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}"
            )
    wxp, grads, r, w = (x.contiguous() for x, _ in shapes)
    partial, ticket, _ = _stream_scratch(_reduce_scratch, wxp.device, reduce_blocks(p), 1)
    out = torch.empty(43, dtype=torch.float32, device=wxp.device)
    kernels.launch("revo_lgsx_reduce", wxp, grads, r, w, out, p, partial, ticket)
    lgsx_reduce.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42]


lgsx_reduce.launches = 0


def residual_terms(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Per-point residual pass up to the reduction (revo_tpu/solver.py
    ``_residual_sums`` up to its ``lgsx_reduce`` call): returns the inputs
    of K3 (warped points (P, 3), fx/fy-scaled gradients (P, 2), residuals
    r (P,), weights w (P,), 0 on dead lanes) plus the good mask and the
    good and bad counts.  ``quad`` is a keyframe level's table as (H*W, C)
    rows (``interp.sample_table``: the dt-only quad table, the
    12-component one, or the structure), ``cloud`` an EdgeCloud, ``cam``
    that level's CameraConfig.  Every term rounds as the jitted JAX pass
    does, so each is bit-equal to the JAX package's."""
    px, py, pz = apply_rt_cols(cloud.points, R, t)
    pz_safe = torch.where(pz == 0, 1e-12, pz)
    u = scale_shift(px / pz_safe, cam.fx, cam.cx)
    v = scale_shift(py / pz_safe, cam.fy, cam.cy)
    # Bounds check, NaN-rejecting by construction (optimizer.cpp:100).
    in_bounds = (u > 1.0) & (v > 1.0) & (u < cam.width - 2.0) & (v < cam.height - 2.0)
    in_bounds = in_bounds & cloud.valid

    samp = sample_table(quad, u, v, cam.height, cam.width)
    r = samp[:, 2]
    grads = torch.stack([cam.fx * samp[:, 0], cam.fy * samp[:, 1]], dim=-1)

    good = in_bounds & (r <= edge_distance) if use_edge_filter else in_bounds
    n_bad = (cloud.valid & ~good).sum().to(torch.int32)
    n_good = good.sum().to(torch.int32)

    # Huber weight (optimizer.h:156-160): 1 for r <= huber, else huber / r,
    # a true division (a Python number over a tensor would be a reciprocal
    # and a product, two roundings).
    r_safe = torch.where(r == 0, 1.0, r)
    w_r = torch.where(r <= huber, 1.0, torch.full_like(r, huber) / r_safe)
    gm = good.to(torch.float32)
    wxp = torch.stack([px, py, pz], dim=-1)
    return wxp, grads, r, w_r * gm, gm, n_good, n_bad


def residual_lgsx_ref(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Plain fused K3 of one lane: ``residual_terms``, ``lgsx_reduce_ref``
    and the unweighted sum as torch ops -> (A, g, sum_w, sum_unw, n_good,
    n_bad)."""
    wxp, grads, r, wg, gm, n_good, n_bad = residual_terms(
        quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter
    )
    A, gvec, sum_w = lgsx_reduce_ref(wxp, grads, r, wg)
    return A, gvec, sum_w, torch.sum(gm * r * r), n_good, n_bad


def _lane_outputs(out: torch.Tensor):
    """(B, 46) output rows -> (A (B, 6, 6), g (B, 6), sum_w (B,), sum_unw
    (B,), n_good (B,) int32, n_bad (B,) int32), views of ``out``."""
    b = out.shape[0]
    counts = out[:, 44:46].view(torch.int32)
    return (out[:, :36].view(b, 6, 6), out[:, 36:42], out[:, 42], out[:, 43],
            counts[:, 0], counts[:, 1])


def residual_lgsx_batched_ref(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter,
                              active=None, out=None):
    """Plain version of ``residual_lgsx_batched``: ``residual_lgsx_ref`` lane
    by lane, so each lane sums in the one-lane order, written into the rows
    of ``out`` that ``active`` selects."""
    b = R.shape[0]
    if out is None:
        out = torch.zeros((b, 46), dtype=torch.float32, device=R.device)
    on = [True] * b if active is None else active.tolist()
    for lane in range(b):
        if not on[lane]:
            continue
        lane_cloud = EdgeCloud(points=cloud.points[lane], valid=cloud.valid[lane], count=None)
        A, g, sw, su, ng, nb = residual_lgsx_ref(
            quad[lane], lane_cloud, cam, R[lane], t[lane], edge_distance, huber,
            use_edge_filter,
        )
        out[lane, :36] = A.reshape(-1)
        out[lane, 36:42] = g
        out[lane, 42] = sw
        out[lane, 43] = su
        out[lane, 44:46].view(torch.int32).copy_(torch.stack([ng, nb]))
    return _lane_outputs(out)


_RL_THREADS = 128  # threads a block (csrc/lgsx.cu RL_THREADS and RD_THREADS)
_RL_ROW = 32  # words per block's partial row (csrc/lgsx.cuh ROW)
# (device, stream) -> (partial rows, tickets, all-lanes mask): the fused
# kernel's and lgsx_reduce's, apart.
_scratch = {}
_reduce_scratch = {}


def reduce_blocks(p: int) -> int:
    """Blocks of one ``lgsx_reduce`` launch over ``p`` points: two points a
    thread, 128 threads a block (csrc/lgsx.cu RD_POINTS, RD_THREADS), and one
    block (which writes zeros) at p = 0."""
    return max(-(-p // (2 * _RL_THREADS)), 1)


def _stream_scratch(table: dict, device, rows: int, lanes: int):
    """Partial rows, per-lane tickets and an all-true lane mask from
    ``table`` for the current stream of ``device``.  Launches on one stream
    run in order and each leaves the tickets of its lanes at 0, so they
    share one buffer; it grows when a call needs more rows or lanes."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    held = table.get(key)
    if held is None or held[0].shape[0] < rows * _RL_ROW or held[1].shape[0] < lanes:
        held = (
            torch.empty(rows * _RL_ROW, dtype=torch.float32, device=device),
            torch.zeros(lanes, dtype=torch.int32, device=device),
            torch.ones(lanes, dtype=torch.bool, device=device),
        )
        table[key] = held
    return held


def _lane_operand(x: torch.Tensor, b: int, lane_shape, dtypes, device, name):
    """``x`` (B, *lane_shape) as the kernel takes it: each lane contiguous
    and lanes a fixed stride apart, 0 when they share one operand (an
    ``expand``).  Returns (tensor, lane stride in elements); copies only a
    view that is neither."""
    if (x.dim() != 1 + len(lane_shape) or x.shape[1:] != lane_shape
            or x.shape[0] not in (1, b)):
        raise ValueError(f"residual_lgsx: {name} want ({b} or 1, *{tuple(lane_shape)}), "
                         f"got {tuple(x.shape)}")
    if x.dtype not in dtypes or x.device != device:
        raise ValueError(f"residual_lgsx: {name} want {dtypes} on {device}, "
                         f"got {x.dtype} on {x.device}")
    if x.is_contiguous():
        return x, (0 if x.shape[0] == 1 else x.stride(0))
    if x.stride(0) == 0 and x[0].is_contiguous():
        return x, 0
    x = x.contiguous()
    return x, (0 if x.shape[0] == 1 else x.stride(0))


# Row layouts of the tables the fused kernel gathers, by (row width, dtype)
# (csrc/lgsx.cu ``Layout``), and the alignment in bytes of each one's loads.
_LAYOUTS = {
    (4, torch.float32): 0,  # "dt4": dt taps, one 16-byte load
    (4, torch.bfloat16): 1,  # "dt4bf": one 8-byte load
    (12, torch.float32): 2,  # 12-component quad rows: three 16-byte loads
    (12, torch.bfloat16): 3,  # "flatbf": three 8-byte loads
    (3, torch.float32): 4,  # the (gx, gy, dt) structure: four 12-byte taps
}
_ALIGN = (16, 8, 16, 8, 4)


def table_layout(table: torch.Tensor) -> int:
    """The kernel's layout code of a keyframe level's (..., H*W, C) table;
    raises for a width or dtype no sampler reads."""
    layout = _LAYOUTS.get((table.shape[-1], table.dtype))
    if layout is None:
        raise ValueError(
            f"residual_lgsx: no table layout of rows ({table.shape[-1]},) {table.dtype}: "
            "want (4,) or (12,) float32 / bfloat16, or (3,) float32")
    return layout


class LaneOperands(NamedTuple):
    """The operands of a solver level's fused K3 launches that stay fixed
    while the poses change, checked and laid out once by ``lane_operands``.
    On the CPU ``strides`` and ``scratch`` are None."""

    quad: torch.Tensor  # (B or 1, H*W, C) table, ``table_layout``
    cloud: EdgeCloud  # points (B or 1, P, 3), valid (B or 1, P)
    cam: CameraConfig
    lanes: int
    strides: tuple  # lane strides of quad (in rows), points, valid
    scratch: tuple  # partial rows, tickets, all-lanes mask (B,)


def lane_operands(quad, cloud, cam, lanes: int) -> LaneOperands:
    """Check the pose-independent operands of ``residual_lgsx_lanes`` once:
    ``quad`` (B, H*W, C) (``table_layout``), ``cloud`` points (B, P, 3) and
    valid (B, P), each shareable by the ``lanes`` lanes through ``expand``.
    On the card the scratch is that of the current stream, where the
    launches must run."""
    device = cloud.points.device
    layout = table_layout(quad)
    if device.type == "cpu":
        return LaneOperands(quad, cloud, cam, lanes, None, None)
    if device.type != "cuda":
        raise ValueError(f"residual_lgsx: unsupported device {device}")
    p, c = cloud.points.shape[-2], quad.shape[-1]
    quad, quad_s = _lane_operand(quad, lanes, (cam.height * cam.width, c), (quad.dtype,),
                                 device, "quad")
    points, pts_s = _lane_operand(cloud.points, lanes, (p, 3), (torch.float32,), device,
                                  "points")
    valid, valid_s = _lane_operand(cloud.valid, lanes, (p,), (torch.bool,), device, "valid")
    if quad.data_ptr() % _ALIGN[layout]:
        raise ValueError(f"residual_lgsx: the table must be {_ALIGN[layout]}-byte aligned")
    blocks = max(-(-p // _RL_THREADS), 1)
    # Two buffers of partial rows: the level kernel's, by its evaluations'
    # parity (csrc/level.cu); a residual_lgsx launch uses the first.
    partial, ticket, every_lane = _stream_scratch(_scratch, device, 2 * lanes * blocks, lanes)
    return LaneOperands(quad, EdgeCloud(points=points, valid=valid, count=None), cam, lanes,
                        (quad_s // c, pts_s, valid_s), (partial, ticket, every_lane[:lanes]))


def residual_lgsx_lanes(ops: LaneOperands, R, t, edge_distance, huber, use_edge_filter,
                        active=None, out=None):
    """``residual_lgsx_batched`` on operands ``lane_operands`` checked: per
    call only the poses (R (B, 3, 3), t (B, 3)), ``active`` and ``out`` are
    checked, and on the card the call is one launch."""
    if ops.scratch is None:
        return residual_lgsx_batched_ref(ops.quad, ops.cloud, ops.cam, R, t, edge_distance,
                                         huber, use_edge_filter, active, out)
    b, device, cam = ops.lanes, ops.quad.device, ops.cam
    R, R_s = _lane_operand(R, b, (3, 3), (torch.float32,), device, "R")
    t, t_s = _lane_operand(t, b, (3,), (torch.float32,), device, "t")
    partial, ticket, every_lane = ops.scratch
    if active is None:
        active = every_lane
    elif active.shape != (b,) or active.dtype != torch.bool or not active.is_contiguous():
        raise ValueError(f"residual_lgsx: active want contiguous bool ({b},), "
                         f"got {active.dtype} {tuple(active.shape)}")
    if out is None:
        out = torch.empty((b, 46), dtype=torch.float32, device=device)
    elif out.shape != (b, 46) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"residual_lgsx: out want contiguous float32 ({b}, 46)")
    quad_s, pts_s, valid_s = ops.strides
    layout = table_layout(ops.quad)
    kernels.launch(
        "revo_residual_lgsx",
        ops.quad, layout, quad_s, ops.cloud.points, pts_s,
        ops.cloud.valid, valid_s, R, R_s, t, t_s, active, cam.fx, cam.fy, cam.cx, cam.cy,
        cam.width, cam.height, edge_distance, huber, int(bool(use_edge_filter)),
        ops.cloud.points.shape[-2], b, partial, ticket, out,
    )
    residual_lgsx.launches += 1
    residual_lgsx.layout_launches[layout] += 1
    return _lane_outputs(out)


def residual_lgsx_batched(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter,
                          active=None, out=None):
    """Fused K3 over B lanes: each lane's unnormalized sums (A (B, 6, 6),
    g (B, 6), sum_w (B,), sum_unw (B,), n_good, n_bad (B,) int32) over its
    cloud at its pose (R (B, 3, 3), t (B, 3)) against its keyframe level's
    table (``quad`` (B, H*W, C), ``table_layout``: the dt-only or the
    12-component quad table, float32 or bfloat16, or the float32 structure).
    Any operand may be shared by the lanes through ``expand`` (stride 0).
    ``active`` (B,) bool selects the lanes to evaluate; the rows of ``out``
    (B, 46) of the others stay as they were.  The outputs are views of
    ``out``.  CPU tensors: the plain version lane by lane; CUDA tensors:
    one kernel launch, nothing else, no host sync."""
    ops = lane_operands(quad, cloud, cam, R.shape[0])
    return residual_lgsx_lanes(ops, R, t, edge_distance, huber, use_edge_filter, active, out)


def residual_lgsx(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Fused K3 wrapper, one lane: one evaluation's unnormalized sums
    (A (6, 6), g (6,), sum_w, sum_unw, n_good, n_bad (int32)) over the cloud
    at pose (R, t) against a keyframe level's (H*W, C) table
    (``table_layout``): ``residual_lgsx_batched`` at B = 1.  ``launches``
    counts the kernel's launches at any B, ``layout_launches`` the same by
    table layout."""
    lane = EdgeCloud(points=cloud.points[None], valid=cloud.valid[None], count=None)
    outs = residual_lgsx_batched(
        quad[None], lane, cam, R[None], t[None], edge_distance, huber, use_edge_filter
    )
    return tuple(x[0] for x in outs)


residual_lgsx.launches = 0
# Launches by table layout (``table_layout``'s code), beside the total.
residual_lgsx.layout_launches = [0] * len(_ALIGN)
