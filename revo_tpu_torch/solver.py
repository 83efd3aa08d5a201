"""SE(3) LM / fixed-iteration GN over distance-transform residuals
(counterpart of revo_tpu/solver.py, the hot path).

One evaluation (``residual_system``) transforms and projects the (P, 3)
edge cloud, samples the keyframe's dt quad table bilinearly, Huber-weights
and masks the residuals, and reduces the 6x6 normal equations: one launch
of the fused kernel K3 (``ops.lgsx.residual_lgsx``), whose plain version
is ``ops.lgsx.residual_terms`` and the einsums.  Sign conventions follow the
reference: the keyframe structure stores negated central differences
(imgpyramidrgbd.cpp:267-274) and the update solves
inc = (A + lambda diag(A))^-1 g, which is descent under that sign
(optimizer.cpp:258).

JAX's ``while_loop``s are Python loops here.  Each evaluation reads its
accept/stop flags on the host: one device-to-host sync per evaluation,
which capturing a level's loop in a CUDA graph would remove.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from revo_tpu_torch import lie
from revo_tpu_torch.config import CameraConfig, OptimizerConfig
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.ops.lgsx import residual_lgsx
from revo_tpu_torch.ops.project import apply_rt_cols, scale_shift


class ResidualInfo(NamedTuple):
    """Optimizer::ResidualInfo (optimizer.h:118-140)."""

    good: torch.Tensor  # () int32 goodPtsEdges
    bad: torch.Tensor  # () int32 out of bounds + edge-filtered
    sum_error_weighted: torch.Tensor  # () float32
    sum_error_unweighted: torch.Tensor  # () float32


class LevelSystem(NamedTuple):
    """One evaluation: mean error and normalized 6x6 normal equations."""

    err: torch.Tensor  # () sumErrorWeighted / good
    A: torch.Tensor  # (6, 6) sum(w J J^T) / good
    g: torch.Tensor  # (6,) sum(w J r) / good
    info: ResidualInfo


def solve6_ldlt(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-(semi)definite 6x6 A by an
    unrolled pivot-free LDL^T (the reference uses Eigen ldlt,
    optimizer.cpp:263); zero pivots are clamped to 1e-30 to keep x finite."""
    n = 6
    L = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k] * d[k]
        d[j] = torch.where(torch.abs(s) < 1e-30, 1e-30, s)
        for i in range(j + 1, n):
            t = A[i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k] * d[k]
            L[i][j] = t / d[j]
    y = [None] * n
    for i in range(n):
        t = b[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i] / d[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t
    return torch.stack(x)


def _solve_damped(Ad, g, impl: str):
    if impl == "ldlt":
        return solve6_ldlt(Ad, g)
    return torch.linalg.solve(Ad, g)


def _residual_sums(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Unnormalized sums over the cloud: (A, g, sum_w, sum_unw, n_good,
    n_bad).  On the card this is one launch of the fused kernel and nothing
    else; on the CPU its plain version (``residual_terms`` + the einsums)."""
    return residual_lgsx(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter)


def _normalize_sums(A, gvec, sum_w, sum_unw, n_good, n_bad) -> LevelSystem:
    n = torch.clamp(n_good, min=1).to(torch.float32)
    return LevelSystem(
        err=sum_w / n,
        A=A / n,
        g=gvec / n,
        info=ResidualInfo(
            good=n_good, bad=n_bad, sum_error_weighted=sum_w,
            sum_error_unweighted=sum_unw,
        ),
    )


def residual_system(
    quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter
) -> LevelSystem:
    """calcErrorAndBuffers + calculateWarpUpdate as one dense pass
    (optimizer.cpp:74-234): the good-points-only normal equations divided by
    the good count (LGSX.h:320-326)."""
    return _normalize_sums(
        *_residual_sums(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter)
    )


def _damped_step(sys: LevelSystem, lam, R, t, impl: str):
    """Candidate pose of one damped solve: A(i,i) *= 1 + lambda
    (optimizer.cpp:261-262); a non-finite increment becomes 0."""
    Ad = sys.A + torch.diag(torch.diagonal(sys.A) * lam)
    inc = _solve_damped(Ad, sys.g, impl)
    inc = torch.where(torch.isfinite(inc), inc, 0.0)
    dR, dt_ = lie.exp_se3(inc)
    Rn, tn = lie.compose(dR, dt_, R, t)
    return inc, Rn, tn


def _check_quad(quad: torch.Tensor, opt: OptimizerConfig):
    if not opt.bilinear_impl.startswith("quad") or quad.dim() != 2 or quad.shape[-1] != 4:
        raise ValueError(
            "the port samples (H*W, 4) dt quad tables only: needs a quad "
            f"bilinear_impl and quad_form 'dt4'/'dt4bf' (got {opt.bilinear_impl!r}, "
            f"table {tuple(quad.shape)})"
        )


def lm_level(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int, max_inner: int = 32):
    """One pyramid level of LM (Optimizer::trackFrames,
    optimizer.cpp:235-311): accept on error decrease (lambda *= success
    factor, converge when err/last_err > eps); on reject raise lambda by
    fail_fac^inc_try, stop the level when |inc|^2 <= step_size_min.
    ``max_inner`` bounds the reference's unbounded retry loop.
    Returns (R, t, last_err, info)."""
    _check_quad(quad, opt)
    max_its = opt.max_its_per_lvl[lvl]
    edge_dist = opt.edge_distance_lvl[lvl]
    conv_eps = opt.convergence_eps[lvl]
    step_min = opt.step_size_min[lvl]

    def evaluate(R, t):
        return residual_system(
            quad, cloud, cam, R, t, edge_dist, opt.huber_edge, opt.use_edge_filter
        )

    R, t = R0, t0
    sys = evaluate(R, t)
    last_err = sys.err
    lam = torch.full((), opt.lambda_initial[lvl], dtype=torch.float32, device=R.device)
    iteration = 0
    while iteration < max_its:
        base = sys
        inc_try = 0
        done = False
        while not done and inc_try < max_inner:
            inc, Rn, tn = _damped_step(base, lam, R, t, opt.solve6_impl)
            inc_try += 1
            sys_n = evaluate(Rn, tn)
            err = sys_n.err
            flags = torch.stack([
                err < last_err,
                err / torch.clamp(last_err, min=1e-30) > conv_eps,
                ~(torch.dot(inc, inc) > step_min),
            ])
            accept, converged, small_step = flags.tolist()  # the host sync
            if accept:
                R, t, sys, last_err = Rn, tn, sys_n, err
                lam = torch.where(lam <= 0.2, 0.0, lam * opt.lambda_success_fac)
                if converged:
                    iteration = max_its
            else:
                lam = torch.where(
                    lam == 0.0, 0.2,
                    lam * torch.full_like(lam, opt.lambda_fail_fac) ** inc_try,
                )
                if small_step:
                    iteration = max_its
            done = accept or small_step
        iteration = min(iteration + 1, max_its)
    return R, t, last_err, sys.info


def gn_level_fixed(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """Bounded branchless LM, the JAX package's batched fast path
    (solver._gn_level_fixed): at most fixed_iters[lvl] + 1 evaluations, the
    first of which evaluates the initial pose.  Accept on error decrease
    (lambda *= success factor, stop when err/last_err > eps); on reject keep
    the linearization, escalate lambda (to 0.2, then by
    fail_fac^inc_try), and stop when the step is tiny or the candidate is
    barely worse (err/last_err < 2 - eps).  Returns (R, t, err, info)."""
    _check_quad(quad, opt)
    iters = opt.fixed_iters[lvl]
    edge_dist = opt.edge_distance_lvl[lvl]
    conv_eps = opt.convergence_eps[lvl]
    step_min = opt.step_size_min[lvl]
    dev = R0.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    # Iteration 0 damps a zero system: inc = 0, so its candidate is
    # exactly (R0, t0) and it always accepts against err = inf.
    sys = LevelSystem(
        err=torch.full((), float("inf"), device=dev),
        A=torch.zeros((6, 6), device=dev),
        g=torch.zeros(6, device=dev),
        info=ResidualInfo(zero_i, zero_i, zero_f, zero_f),
    )
    lam = torch.full((), opt.lambda_initial[lvl] + 1e-5, dtype=torch.float32, device=dev)
    fail = torch.full((), opt.lambda_fail_fac, dtype=torch.float32, device=dev)
    R, t = R0, t0
    i, inc_try, done = 0, 0, False
    while i < iters + 1 and not done:
        inc, Rn, tn = _damped_step(sys, lam, R, t, opt.solve6_impl)
        sys_n = residual_system(
            quad, cloud, cam, Rn, tn, edge_dist, opt.huber_edge, opt.use_edge_filter
        )
        ratio = sys_n.err / torch.clamp(sys.err, min=1e-30)
        flags = torch.stack([
            sys_n.err < sys.err,
            ratio > conv_eps,
            ratio < (2.0 - conv_eps),
            ~(torch.dot(inc, inc) > step_min),
        ])
        accept, converged, flat, small_step = flags.tolist()  # the host sync
        first = i == 0
        done = (converged if accept else (small_step or flat)) and not first
        if accept:
            R, t, sys = Rn, tn, sys_n
        inc_try = 0 if accept else inc_try + 1
        if not first:
            if accept:
                lam = lam * opt.lambda_success_fac
            else:
                lam = torch.where(
                    lam < 0.2,
                    torch.clamp(lam * opt.lambda_fail_fac, min=0.2),
                    lam * fail ** inc_try,
                )
        i += 1
    return R, t, sys.err, sys.info


def solve_level(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """Dispatch on OptimizerConfig.solver."""
    if opt.solver == "gn_fixed":
        return gn_level_fixed(quad, cloud, cam, R0, t0, opt, lvl)
    if opt.solver == "lm":
        return lm_level(quad, cloud, cam, R0, t0, opt, lvl)
    raise ValueError(f"unknown solver {opt.solver!r}")


def eval_cost(
    dt_img: torch.Tensor,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R: torch.Tensor,
    t: torch.Tensor,
    edge_distance: float,
    use_edge_filter: bool,
    normalized: bool = False,
) -> torch.Tensor:
    """TrackerNew::evalCostFunction (tracker.cpp:356-393): sum of
    floor-sampled DT values over in-bounds points passing the edge filter;
    ``normalized`` divides by the contributing-point count."""
    wx, wy, wz = apply_rt_cols(cloud.points, R, t)
    pz = torch.where(wz == 0, 1e-12, wz)
    u = scale_shift(wx / pz, cam.fx, cam.cx)
    v = scale_shift(wy / pz, cam.fy, cam.cy)
    inb = (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
    inb = inb & cloud.valid
    ui = torch.nan_to_num(torch.floor(u), nan=0.0).clamp(0, cam.width - 1).to(torch.int64)
    vi = torch.nan_to_num(torch.floor(v), nan=0.0).clamp(0, cam.height - 1).to(torch.int64)
    res = dt_img.reshape(-1)[vi * cam.width + ui]
    ok = inb & (res <= edge_distance) if use_edge_filter else inb
    total = torch.sum(torch.where(ok, res, 0.0))
    if normalized:
        return total / torch.clamp(ok.sum(), min=1).to(torch.float32)
    return total
