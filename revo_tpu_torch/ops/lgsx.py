"""K3: the LGSX normal-equation reduction (counterpart of
revo_tpu/ops/pallas/lgsx.py::lgsx_reduce), alone and fused with the
residual pass that feeds it.

``lgsx_reduce``: from warped points (P, 3), fx/fy-scaled DT gradients
(P, 2), residuals (P,) and weights (P,) (0 on dead lanes) form each point's
6-dof Jacobian row (optimizer.cpp:216-228) and reduce A = sum w J J^T,
g = sum w J r and s = sum w r^2, unnormalized (the caller divides by the
good count).  This is the TPU kernel's own contract.

``residual_lgsx`` is what the solver calls once per evaluation: the whole
residual pass (``residual_terms``: transform, project, bounds-check, sample
the dt quad table, edge filter, Huber weight) and that reduction, plus the
unweighted error sum and the good and bad counts, in one kernel launch that
reads the pose from device memory and needs no host sync.

Each has a plain PyTorch version beside it (``lgsx_reduce_ref``, the JAX
solver's einsum path, solver.py:264-281; ``residual_lgsx_ref``).  A wrapper
runs the plain version for a CPU tensor and its CUDA kernel
(revo_tpu_torch/csrc/lgsx.cu) for a tensor on the card, and raises for any
other device; ``launches`` on each wrapper counts its kernel launches.
"""
from __future__ import annotations

import torch

from revo_tpu_torch import kernels
from revo_tpu_torch.ops.interp import bilinear_sample_dtquad
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
    """K3 wrapper.  CPU tensors: plain version; CUDA tensors: the kernel."""
    if wxp.device.type == "cpu":
        return lgsx_reduce_ref(wxp, grads, r, w)
    if wxp.device.type != "cuda":
        raise ValueError(f"lgsx_reduce: unsupported device {wxp.device}")
    p = wxp.shape[0]
    shapes = ((wxp, (p, 3)), (grads, (p, 2)), (r, (p,)), (w, (p,)))
    for x, shape in shapes:
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(
                f"lgsx_reduce: want float32 {shape}, got {x.dtype} {tuple(x.shape)}"
            )
    wxp, grads, r, w = (x.contiguous() for x, _ in shapes)
    out = torch.empty(43, dtype=torch.float32, device=wxp.device)
    kernels.launch("revo_lgsx_reduce", wxp, grads, r, w, out, p)
    lgsx_reduce.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42]


lgsx_reduce.launches = 0


def residual_terms(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Per-point residual pass up to the reduction: returns the inputs of
    K3 (warped points (P, 3), fx/fy-scaled gradients (P, 2), residuals r
    (P,), weights w (P,), 0 on dead lanes) plus the good mask and the good
    and bad counts.  ``quad`` is a keyframe level's (H*W, 4) dt table,
    ``cloud`` an EdgeCloud, ``cam`` that level's CameraConfig."""
    px, py, pz = apply_rt_cols(cloud.points, R, t)
    pz_safe = torch.where(pz == 0, 1e-12, pz)
    u = scale_shift(px / pz_safe, cam.fx, cam.cx)
    v = scale_shift(py / pz_safe, cam.fy, cam.cy)
    # Bounds check, NaN-rejecting by construction (optimizer.cpp:100).
    in_bounds = (u > 1.0) & (v > 1.0) & (u < cam.width - 2.0) & (v < cam.height - 2.0)
    in_bounds = in_bounds & cloud.valid

    samp = bilinear_sample_dtquad(quad, u, v, cam.height, cam.width)
    r = samp[:, 2]
    grads = torch.stack([cam.fx * samp[:, 0], cam.fy * samp[:, 1]], dim=-1)

    good = in_bounds & (r <= edge_distance) if use_edge_filter else in_bounds
    n_bad = (cloud.valid & ~good).sum().to(torch.int32)
    n_good = good.sum().to(torch.int32)

    # Huber weight (optimizer.h:156-160): 1 for r <= huber, else huber / r.
    r_safe = torch.where(r == 0, 1.0, r)
    w_r = torch.where(r <= huber, 1.0, huber / r_safe)
    gm = good.to(torch.float32)
    wxp = torch.stack([px, py, pz], dim=-1)
    return wxp, grads, r, w_r * gm, gm, n_good, n_bad


def residual_lgsx_ref(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Plain fused K3: ``residual_terms``, ``lgsx_reduce_ref`` and the
    unweighted sum as torch ops -> (A, g, sum_w, sum_unw, n_good, n_bad)."""
    wxp, grads, r, wg, gm, n_good, n_bad = residual_terms(
        quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter
    )
    A, gvec, sum_w = lgsx_reduce_ref(wxp, grads, r, wg)
    return A, gvec, sum_w, torch.sum(gm * r * r), n_good, n_bad


_RL_THREADS = 128  # points per block (csrc/lgsx.cu RL_THREADS)
_RL_ROW = 32  # words per block's partial row (csrc/lgsx.cu ROW)
_scratch = {}  # (device, stream) -> (partial rows, ticket)


def _residual_scratch(device, blocks: int):
    """The fused kernel's partial rows and ticket on the current stream of
    ``device``.  Launches on one stream run in order and each leaves the
    ticket at 0, so they share one buffer; it grows when a cloud needs more
    rows."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    held = _scratch.get(key)
    if held is None or held[0].shape[0] < blocks * _RL_ROW:
        held = (
            torch.empty(blocks * _RL_ROW, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
        )
        _scratch[key] = held
    return held


def residual_lgsx(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Fused K3 wrapper: one evaluation's unnormalized sums (A (6, 6),
    g (6,), sum_w, sum_unw, n_good, n_bad (int32)) over the cloud at pose
    (R, t) against a keyframe level's (H*W, 4) dt quad table, float32 or
    bfloat16.  CPU tensors: plain version; CUDA tensors: one kernel launch,
    nothing else, the outputs views of one (46,) buffer."""
    device = cloud.points.device
    if device.type == "cpu":
        return residual_lgsx_ref(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter)
    if device.type != "cuda":
        raise ValueError(f"residual_lgsx: unsupported device {device}")
    p = cloud.points.shape[0]
    h, w = cam.height, cam.width
    # Contiguous copies only where a caller hands in a view (a pose cut from
    # a 4x4, say); the usual operands pass through untouched.
    points, valid = cloud.points.contiguous(), cloud.valid.contiguous()
    R, t = R.contiguous(), t.contiguous()
    wants = (
        (quad, (torch.float32, torch.bfloat16), (h * w, 4)),
        (points, (torch.float32,), (p, 3)),
        (valid, (torch.bool,), (p,)),
        (R, (torch.float32,), (3, 3)),
        (t, (torch.float32,), (3,)),
    )
    for x, dtypes, shape in wants:
        if (x.dtype not in dtypes or tuple(x.shape) != shape or x.device != device
                or not x.is_contiguous()):
            raise ValueError(
                f"residual_lgsx: want contiguous {dtypes} {shape} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device} contiguous={x.is_contiguous()}"
            )
    if quad.data_ptr() % 16:
        raise ValueError("residual_lgsx: the quad table must be 16-byte aligned")
    partial, ticket = _residual_scratch(device, max(-(-p // _RL_THREADS), 1))
    out = torch.empty(46, dtype=torch.float32, device=device)
    kernels.launch(
        "revo_residual_lgsx",
        quad, int(quad.dtype == torch.bfloat16), points, valid, R, t,
        cam.fx, cam.fy, cam.cx, cam.cy, w, h, edge_distance, huber,
        int(bool(use_edge_filter)), p, partial, ticket, out,
    )
    residual_lgsx.launches += 1
    counts = out[44:46].view(torch.int32)
    return out[:36].view(6, 6), out[36:42], out[42], out[43], counts[0], counts[1]


residual_lgsx.launches = 0
