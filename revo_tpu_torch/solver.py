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

The solvers run B independent lanes at once (``lm_level_batched``,
``gn_level_fixed_batched``), what the JAX package gets from ``vmap`` of its
``while_loop``s: every lane keeps its own pose, system and lambda on the
device and its retry count and iteration on the host, the loop runs while
any lane is active, and a lane that has stopped is frozen with
``torch.where`` and skipped by the kernel.  Each evaluation reads the
(B, k) accept/stop flags on the host in one device-to-host sync, which
capturing a level's loop in a CUDA graph would remove; the host's
bookkeeping decides from them, and sends the kernel its lane mask in one
small asynchronous copy once a lane has stopped.  Each lane's op sequence
is the one-lane sequence, so its bits are those of the same lane run
alone; ``lm_level`` and ``gn_level_fixed`` are the B = 1 case.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from revo_tpu_torch import lie
from revo_tpu_torch.config import CameraConfig, OptimizerConfig
from revo_tpu_torch.lanes import lane
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.ops.lgsx import lane_operands, residual_lgsx, residual_lgsx_lanes
from revo_tpu_torch.ops.project import apply_rt_cols, scale_shift
from revo_tpu_torch.parallel.mesh import psum, replicate, shard


class ResidualInfo(NamedTuple):
    """Optimizer::ResidualInfo (optimizer.h:118-140); a leading lane axis
    on every field in the batched solvers."""

    good: torch.Tensor  # () int32 goodPtsEdges
    bad: torch.Tensor  # () int32 out of bounds + edge-filtered
    sum_error_weighted: torch.Tensor  # () float32
    sum_error_unweighted: torch.Tensor  # () float32


class LevelSystem(NamedTuple):
    """One evaluation: mean error and normalized 6x6 normal equations (a
    leading lane axis on every field in the batched solvers)."""

    err: torch.Tensor  # () sumErrorWeighted / good
    A: torch.Tensor  # (6, 6) sum(w J J^T) / good
    g: torch.Tensor  # (6,) sum(w J r) / good
    info: ResidualInfo


def _where_tree(mask: torch.Tensor, a, b):
    """Per lane ``a`` where ``mask`` (B,) else ``b``, over NamedTuples of
    tensors with a leading lane axis."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)
    return type(a)(*(_where_tree(mask, x, y) for x, y in zip(a, b)))


def sq_norm6(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over the last axis of (..., 6) float32 vectors as elementwise
    ops, ((p0 + p4) + (p1 + p5)) + (p2 + p3) of the products p, each
    rounded: how PyTorch's CPU ``torch.dot`` of six float32 values rounds,
    and the same bits for every lane on any device."""
    p = v * v
    return ((p[..., 0] + p[..., 4]) + (p[..., 1] + p[..., 5])) + (p[..., 2] + p[..., 3])


def solve6_ldlt(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-(semi)definite 6x6 A
    (..., 6, 6), b (..., 6) by an elementwise unrolled pivot-free LDL^T
    (the reference uses Eigen ldlt, optimizer.cpp:263); zero pivots are
    clamped to 1e-30 to keep x finite."""
    n = 6
    L = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k] * d[k]
        d[j] = torch.where(torch.abs(s) < 1e-30, 1e-30, s)
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k] * d[k]
            L[i][j] = t / d[j]
    y = [None] * n
    for i in range(n):
        t = b[..., i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i] / d[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t
    return torch.stack(x, dim=-1)


def _solve_damped(Ad, g, impl: str):
    if impl == "ldlt":
        return solve6_ldlt(Ad, g)
    # solve_ex does not raise on a singular system (gn_fixed's first step
    # damps a zero one): its non-finite increment becomes 0, as in JAX.
    return torch.linalg.solve_ex(Ad, g)[0]


def _residual_sums(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter):
    """Unnormalized sums over the cloud: (A, g, sum_w, sum_unw, n_good,
    n_bad).  On the card this is one launch of the fused kernel and nothing
    else; on the CPU its plain version (``residual_terms`` + the einsums)."""
    return residual_lgsx(quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter)


def _normalize_sums(A, gvec, sum_w, sum_unw, n_good, n_bad) -> LevelSystem:
    n = torch.clamp(n_good, min=1).to(torch.float32)
    return LevelSystem(
        err=sum_w / n,
        A=A / n[..., None, None],
        g=gvec / n[..., None],
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


def residual_system_point_sharded(
    quad, cloud, cam, R, t, edge_distance, huber, use_edge_filter, mesh, axis: str = "pt"
) -> LevelSystem:
    """``residual_system`` with the edge points sharded over ``axis`` of
    ``mesh``: each slot reduces its share of the cloud (one fused K3 launch
    on the card) against a replicated quad table and pose, the unnormalized
    sums meet in ``psum`` and are normalized once.  The points must divide
    by the axis size (pad with invalid lanes); the kernel reads only the
    quad table by vector loads, so any slice of the points serves."""
    sums = []
    for quad_s, pts, valid, R_s, t_s in zip(
        replicate(quad, mesh, axis), shard(cloud.points, mesh, axis),
        shard(cloud.valid, mesh, axis), replicate(R, mesh, axis), replicate(t, mesh, axis),
    ):
        local = EdgeCloud(points=pts, valid=valid, count=valid.sum(dtype=torch.int32))
        sums.append(_residual_sums(quad_s, local, cam, R_s, t_s, edge_distance, huber,
                                   use_edge_filter))
    return _normalize_sums(*(psum(parts, mesh, axis) for parts in zip(*sums)))


def _damped_step(sys: LevelSystem, lam, R, t, impl: str):
    """Candidate pose of one damped solve: A(i,i) *= 1 + lambda
    (optimizer.cpp:261-262); a non-finite increment becomes 0."""
    Ad = sys.A + torch.diag_embed(torch.diagonal(sys.A, dim1=-2, dim2=-1) * lam[..., None])
    inc = _solve_damped(Ad, sys.g, impl)
    inc = torch.where(torch.isfinite(inc), inc, 0.0)
    dR, dt_ = lie.exp_se3(inc)
    Rn, tn = lie.compose(dR, dt_, R, t)
    return inc, Rn, tn


def _check_quad(quad: torch.Tensor, opt: OptimizerConfig):
    if not opt.bilinear_impl.startswith("quad") or quad.dim() != 3 or quad.shape[-1] != 4:
        raise ValueError(
            "the port samples (B, H*W, 4) dt quad tables only: needs a quad "
            f"bilinear_impl and quad_form 'dt4'/'dt4bf' (got {opt.bilinear_impl!r}, "
            f"table {tuple(quad.shape)})"
        )


def _evaluate(ops, R, t, edge_distance, opt: OptimizerConfig, active=None) -> LevelSystem:
    """``residual_system`` of every lane (or those ``active`` (B,) selects;
    the others' rows hold garbage for the caller to mask): one fused K3
    launch on operands ``lgsx.lane_operands`` checked once per level."""
    return _normalize_sums(*residual_lgsx_lanes(
        ops, R, t, edge_distance, opt.huber_edge, opt.use_edge_filter, active
    ))


def _take_lanes(takes, accept, active, new, old):
    """Per lane the tensors of ``new`` where the lane took its candidate
    (host list ``takes``; on the device ``accept`` & ``active``), else those
    of ``old``; no launch when every lane or none took it."""
    if all(takes):
        return new
    if not any(takes):
        return old
    take = accept if active is None else accept & active
    return [_where_tree(take, a, b) for a, b in zip(new, old)]


def _merge_lanes(acc, rej, lam_acc, lam_rej, accept, active, lam):
    """New lambda: ``lam_acc()`` on the accepting lanes ``acc``,
    ``lam_rej()`` on the rejecting lanes ``rej``, ``lam`` on stopped lanes
    (``active`` None: none).  A branch no lane takes is not computed."""
    if not rej:
        new = lam_acc()
    elif not acc:
        new = lam_rej()
    else:
        new = torch.where(accept, lam_acc(), lam_rej())
    return new if active is None else torch.where(active, new, lam)


def _fail_powers(fail: torch.Tensor, tries, rej) -> torch.Tensor:
    """(B,) fail ** tries[lane] on the lanes in ``rej`` (1 elsewhere), each
    power taken on the () tensor ``fail`` with a Python exponent, the
    one-lane op."""
    pows = {k: fail ** k for k in {tries[lane] for lane in rej}}
    one = torch.ones_like(fail) if len(rej) < len(tries) else None
    return torch.stack([pows[tries[lane]] if lane in rej else one for lane in range(len(tries))])


def _active(live, dev):
    """The kernel's and the freeze's (B,) lane mask from the host's list;
    None while every lane is live.  To the card it goes in one small copy
    from pinned memory that queues behind the stream's work, so the host
    does not wait for the device."""
    if all(live):
        return None
    if dev.type != "cuda":
        return torch.tensor(live, dtype=torch.bool, device=dev)
    return torch.tensor(live, dtype=torch.bool, pin_memory=True).to(dev, non_blocking=True)


def lm_level_batched(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int,
                     max_inner: int = 32):
    """One pyramid level of LM (Optimizer::trackFrames,
    optimizer.cpp:235-311) over B lanes (quad (B, H*W, 4), cloud points
    (B, P, 3), any operand shareable by ``expand``; R0 (B, 3, 3), t0 (B, 3)):
    accept on error decrease (lambda *= success factor, converge when
    err/last_err > eps); on reject raise lambda by fail_fac^inc_try, stop
    the level when |inc|^2 <= step_size_min.  ``max_inner`` bounds the
    reference's unbounded retry loop.  Every evaluation is one try of every
    active lane: the JAX package's nested while loops, vmapped, unrolled
    into one loop of per-lane state, which the host keeps from the flags it
    reads.  Returns (R, t, last_err, info), each with the lane axis."""
    _check_quad(quad, opt)
    max_its = opt.max_its_per_lvl[lvl]
    edge_dist = opt.edge_distance_lvl[lvl]
    conv_eps = opt.convergence_eps[lvl]
    step_min = opt.step_size_min[lvl]
    b, dev = R0.shape[0], R0.device
    ops = lane_operands(quad, cloud, cam, b)
    R, t = R0, t0
    sys = _evaluate(ops, R, t, edge_dist, opt)
    last_err = sys.err
    lam = torch.full((b,), opt.lambda_initial[lvl], dtype=torch.float32, device=dev)
    fail = torch.full((), opt.lambda_fail_fac, dtype=torch.float32, device=dev)
    iteration, tries = [0] * b, [0] * b
    while any(it < max_its for it in iteration):
        live = [it < max_its for it in iteration]
        active = _active(live, dev)
        inc, Rn, tn = _damped_step(sys, lam, R, t, opt.solve6_impl)
        for lane in range(b):
            tries[lane] += live[lane]
        sys_n = _evaluate(ops, Rn, tn, edge_dist, opt, active)
        err = sys_n.err
        flags = torch.stack([
            err < last_err,
            err / torch.clamp(last_err, min=1e-30) > conv_eps,
            ~(sq_norm6(inc) > step_min),
        ], dim=-1)
        host = flags.tolist()  # the host sync: one per evaluation, all lanes
        accept = flags[:, 0]
        acc = [lane for lane in range(b) if live[lane] and host[lane][0]]
        rej = {lane for lane in range(b) if live[lane] and not host[lane][0]}
        R, t, sys, last_err = _take_lanes(
            [live[lane] and host[lane][0] for lane in range(b)], accept, active,
            (Rn, tn, sys_n, err), (R, t, sys, last_err),
        )
        lam = _merge_lanes(
            acc, rej,
            lambda: torch.where(lam <= 0.2, 0.0, lam * opt.lambda_success_fac),
            lambda: torch.where(lam == 0.0, 0.2, lam * _fail_powers(fail, tries, rej)),
            accept, active, lam,
        )
        for lane in range(b):
            if not live[lane]:
                continue
            a, conv, small = host[lane]
            if (a and conv) or (not a and small):
                iteration[lane] = max_its
            if a or small or tries[lane] >= max_inner:
                iteration[lane] = min(iteration[lane] + 1, max_its)
                tries[lane] = 0
    return R, t, last_err, sys.info


def gn_level_fixed_batched(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """Bounded branchless LM over B lanes, the JAX package's batched fast
    path (solver._gn_level_fixed and its batching rule, solver.py:609-697):
    at most fixed_iters[lvl] + 1 evaluations, the first of which evaluates
    the initial pose.  Accept on error decrease (lambda *= success factor,
    stop when err/last_err > eps); on reject keep the linearization,
    escalate lambda (to 0.2, then by fail_fac^inc_try), and stop when the
    step is tiny or the candidate is barely worse (err/last_err < 2 - eps).
    Lanes step together; a stopped lane is frozen.  Returns (R, t, err,
    info), each with the lane axis."""
    _check_quad(quad, opt)
    iters = opt.fixed_iters[lvl]
    edge_dist = opt.edge_distance_lvl[lvl]
    conv_eps = opt.convergence_eps[lvl]
    step_min = opt.step_size_min[lvl]
    b, dev = R0.shape[0], R0.device
    ops = lane_operands(quad, cloud, cam, b)
    zero_i = torch.zeros(b, dtype=torch.int32, device=dev)
    zero_f = torch.zeros(b, dtype=torch.float32, device=dev)
    # Iteration 0 damps a zero system: inc = 0, so its candidate is
    # exactly (R0, t0) and it always accepts against err = inf.
    sys = LevelSystem(
        err=torch.full((b,), float("inf"), device=dev),
        A=torch.zeros((b, 6, 6), device=dev),
        g=torch.zeros((b, 6), device=dev),
        info=ResidualInfo(zero_i, zero_i, zero_f, zero_f),
    )
    lam = torch.full((b,), opt.lambda_initial[lvl] + 1e-5, dtype=torch.float32, device=dev)
    fail = torch.full((), opt.lambda_fail_fac, dtype=torch.float32, device=dev)
    R, t = R0, t0
    done, tries = [False] * b, [0] * b
    i = 0
    while i < iters + 1 and not all(done):
        live = [not d for d in done]
        active = _active(live, dev)
        inc, Rn, tn = _damped_step(sys, lam, R, t, opt.solve6_impl)
        sys_n = _evaluate(ops, Rn, tn, edge_dist, opt, active)
        ratio = sys_n.err / torch.clamp(sys.err, min=1e-30)
        flags = torch.stack([
            sys_n.err < sys.err,
            ratio > conv_eps,
            ratio < (2.0 - conv_eps),
            ~(sq_norm6(inc) > step_min),
        ], dim=-1)
        host = flags.tolist()  # the host sync: one per evaluation, all lanes
        accept = flags[:, 0]
        acc = [lane for lane in range(b) if live[lane] and host[lane][0]]
        rej = {lane for lane in range(b) if live[lane] and not host[lane][0]}
        R, t, sys = _take_lanes(
            [live[lane] and host[lane][0] for lane in range(b)], accept, active,
            (Rn, tn, sys_n), (R, t, sys),
        )
        for lane in acc:
            tries[lane] = 0
        for lane in rej:
            tries[lane] += 1
        if i > 0:
            lam = _merge_lanes(
                acc, rej,
                lambda: lam * opt.lambda_success_fac,
                lambda: torch.where(lam < 0.2, torch.clamp(lam * opt.lambda_fail_fac, min=0.2),
                                    lam * _fail_powers(fail, tries, rej)),
                accept, active, lam,
            )
            for lane in range(b):
                a, conv, fl, small = host[lane]
                done[lane] = done[lane] or (live[lane] and (conv if a else (small or fl)))
        i += 1
    return R, t, sys.err, sys.info


def _one_lane(fn, quad, cloud, cam, R0, t0, *args):
    """``fn``, a batched solver, at B = 1 on one lane's operands; returns
    that lane's outputs."""
    one = EdgeCloud(points=cloud.points[None], valid=cloud.valid[None], count=None)
    return lane(fn(quad[None], one, cam, R0[None], t0[None], *args), 0)


def lm_level(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int, max_inner: int = 32):
    """``lm_level_batched`` for one lane: quad (H*W, 4), cloud (P, 3),
    R0 (3, 3), t0 (3,).  Returns (R, t, last_err, info)."""
    return _one_lane(lm_level_batched, quad, cloud, cam, R0, t0, opt, lvl, max_inner)


def gn_level_fixed(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """``gn_level_fixed_batched`` for one lane.  Returns (R, t, err, info)."""
    return _one_lane(gn_level_fixed_batched, quad, cloud, cam, R0, t0, opt, lvl)


def solve_level_batched(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """Dispatch on OptimizerConfig.solver, over B lanes."""
    if opt.solver == "gn_fixed":
        return gn_level_fixed_batched(quad, cloud, cam, R0, t0, opt, lvl)
    if opt.solver == "lm":
        return lm_level_batched(quad, cloud, cam, R0, t0, opt, lvl)
    raise ValueError(f"unknown solver {opt.solver!r}")


def solve_level(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """``solve_level_batched`` for one lane."""
    return _one_lane(solve_level_batched, quad, cloud, cam, R0, t0, opt, lvl)


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
    ``normalized`` divides by the contributing-point count.  Takes lanes on
    the leading axes (dt_img (..., H, W), cloud points (..., P, 3), R
    (..., 3, 3), t (..., 3)).  The DT values are square roots of integers
    (>= 1 or 0), so their sum in float64 is exact and the same whatever the
    order of the reduction; it is rounded to float32 once."""
    wx, wy, wz = apply_rt_cols(cloud.points, R, t)
    pz = torch.where(wz == 0, 1e-12, wz)
    u = scale_shift(wx / pz, cam.fx, cam.cx)
    v = scale_shift(wy / pz, cam.fy, cam.cy)
    inb = (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
    inb = inb & cloud.valid
    ui = torch.nan_to_num(torch.floor(u), nan=0.0).clamp(0, cam.width - 1).to(torch.int64)
    vi = torch.nan_to_num(torch.floor(v), nan=0.0).clamp(0, cam.height - 1).to(torch.int64)
    flat = dt_img.reshape(*dt_img.shape[:-2], -1).expand(*ui.shape[:-1], -1)
    res = torch.gather(flat, -1, vi * cam.width + ui)
    ok = inb & (res <= edge_distance) if use_edge_filter else inb
    total = torch.where(ok, res, 0.0).to(torch.float64).sum(-1).to(torch.float32)
    if normalized:
        return total / torch.clamp(ok.sum(-1), min=1).to(torch.float32)
    return total
