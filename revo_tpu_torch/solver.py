"""SE(3) LM / fixed-iteration GN over distance-transform residuals
(counterpart of revo_tpu/solver.py, the hot path).

One evaluation (``residual_system``) transforms and projects the (P, 3)
edge cloud, samples the keyframe level's table bilinearly (the dt-only or
12-component quad table, or the structure: ``uses_quad_table``), Huber-weights
and masks the residuals, and reduces the 6x6 normal equations: one launch
of the fused kernel K3 (``ops.lgsx.residual_lgsx``), whose plain version
is ``ops.lgsx.residual_terms`` and the einsums.  Sign conventions follow the
reference: the keyframe structure stores negated central differences
(imgpyramidrgbd.cpp:267-274) and the update solves
inc = (A + lambda diag(A))^-1 g, which is descent under that sign
(optimizer.cpp:258).

The solvers run B independent lanes at once (``lm_level_batched``,
``gn_level_fixed_batched``), what the JAX package gets from ``vmap`` of its
``while_loop``s, and like its jitted loops they keep every lane's state on
the device (``LevelState``): pose, candidate, system, lambda, iteration,
tries and the active byte.  On the card a whole level is one launch,
``solve_level_kernel`` (csrc/level.cu's ``revo_solve_level``: a
thread-block cluster a lane runs the fused K3 pass, the ordered sums and
the step, csrc/solver.cuh's normalisation, accept / lambda / exit rules,
damped 6x6 LDL^T solve, exp and compose, on the lane's state in shared
memory, until the lane's own exit), and
the host reads nothing.  Its plain version is ``solve_level_ref``.  The
two-launch loop it replaced (``residual_lgsx`` and ``solver_step`` an
evaluation, ``level_state``'s "launches" form) gives the same bits and
stays for comparisons; the same loop with the plain step (``solver_step_ref``,
``solver_start_ref``) runs on the CPU, and on the card for
``solve6_impl="linalg"``, whose ``torch.linalg.solve_ex`` no hand kernel
repeats.  The tracker's init check runs inside the coarsest level's kernel
launch (``InitCheckBlock``), else as one ``init_check`` launch before the
level (``init_check_ref`` on the CPU).  Each lane's op sequence is the
one-lane sequence, so its bits are those of the same lane run alone;
``lm_level`` and ``gn_level_fixed`` are the B = 1 case.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from revo_tpu_torch import kernels, lie
from revo_tpu_torch.config import CameraConfig, OptimizerConfig
from revo_tpu_torch.lanes import lane
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.ops.edt import QUAD_FORMS
from revo_tpu_torch.ops.lgsx import (
    LaneOperands, _lane_operand, _lane_outputs, lane_operands, residual_lgsx,
    residual_lgsx_batched_ref, residual_lgsx_lanes, table_layout,
)
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


# OptimizerConfig.bilinear_impl names of the JAX package (solver.py
# ``_BILINEAR`` and the "quad*" gather forms of ``_residual_sums``).  They
# differ only in how its TPU gathers; in the port a "quad*" impl samples the
# keyframe's quad table and any other the (H, W, 3) structure itself, by one
# formula each (``ops.interp.sample_table``).
BILINEAR_IMPLS = (
    "take4", "taps", "window", "pair", "take4_rm", "window_rm", "window_ob",
    "window_ob_rm", "quad", "quad_ob", "quad_fr", "quad_lf", "quad_lf12",
)


def uses_quad_table(opt: OptimizerConfig) -> bool:
    """Whether the solver samples the keyframe's quad table (a "quad*"
    ``bilinear_impl``) or its structure (revo_tpu/tracker.py:65-74).
    Raises ValueError for a ``bilinear_impl`` or ``quad_form`` that the JAX
    package does not know."""
    if opt.bilinear_impl not in BILINEAR_IMPLS:
        raise ValueError(f"unknown bilinear_impl {opt.bilinear_impl!r}; one of {BILINEAR_IMPLS}")
    if opt.quad_form not in QUAD_FORMS:
        raise ValueError(f"unknown quad_form {opt.quad_form!r}; one of {sorted(QUAD_FORMS)}")
    return opt.bilinear_impl.startswith("quad")


class LevelState(NamedTuple):
    """One solver level's per-lane state, every tensor with the lane axis
    (B lanes) and in device memory: what JAX's ``while_loop`` carries
    (revo_tpu/solver.py ``_LMState`` and ``_gn_level_fixed``'s carry), so
    the host keeps no per-lane list.  ``sys`` is the system at (R, t), the
    last accepted one; ``sys.err`` is the last accepted error (JAX's
    ``last_err``, which always equals it).  ``active`` is the byte a lane's
    blocks of ``residual_lgsx`` read: the lane evaluates (Rn, tn) next.
    A level's state lives in one set of tensors: ``solver_start`` (and its
    plain version) makes them, sharing none with its arguments or with each
    other, and ``solver_step`` (and its plain version) writes each step into
    them in place, on any device.  A caller that keeps an earlier state
    keeps a copy."""

    R: torch.Tensor  # (B, 3, 3) pose of the kept system
    t: torch.Tensor  # (B, 3)
    Rn: torch.Tensor  # (B, 3, 3) candidate the next evaluation evaluates
    tn: torch.Tensor  # (B, 3)
    inc: torch.Tensor  # (B, 6) increment that made the candidate
    sys: LevelSystem  # normalized system at (R, t)
    lam: torch.Tensor  # (B,) float32 damping
    iteration: torch.Tensor  # (B,) int32: lm's outer iteration, gn_fixed's evaluations
    tries: torch.Tensor  # (B,) int32: lm's tries this iteration, gn_fixed's rejects in a row
    active: torch.Tensor  # (B,) bool


class StepParams(NamedTuple):
    """A level's schedule as the step takes it (``step_params``)."""

    gn: bool  # gn_fixed's rules, else lm's
    max_iter: int  # lm: max_its; gn_fixed: fixed_iters + 1 evaluations
    max_inner: int  # lm's tries an iteration
    conv_eps: float
    flat_below: float  # gn_fixed's reject exit: err / last_err < 2 - eps
    step_min: float
    success: float  # lambda factors
    fail: float
    lam0: float  # starting lambda
    pows: torch.Tensor  # (n,) float32 fail ** k on the lanes' device (``_fail_table``)
    impl: str  # OptimizerConfig.solve6_impl


_FAIL_TABLES = {}


def _fail_table(fail: float, n: int, device) -> torch.Tensor:
    """(n,) float32 ``fail ** k`` for k < n, each power taken on a () float32
    tensor on ``device`` with a Python int exponent.  The kernel and the
    plain step both read this table,
    so their powers agree bit for bit for any factor.  With the default 2.0
    every power is exact; for another factor a power may round otherwise
    than JAX's float ``pow`` does.  Built once per (factor, n, device), with
    one stream sync on the card."""
    key = (fail, n, torch.device(device))
    table = _FAIL_TABLES.get(key)
    if table is None:
        base = torch.full((), fail, dtype=torch.float32, device=device)
        table = _FAIL_TABLES[key] = torch.stack([base ** k for k in range(n)])
        if table.is_cuda:  # other streams read it later: its fill must be done
            torch.cuda.current_stream(table.device).synchronize()
    return table


def step_params(opt: OptimizerConfig, lvl: int, gn: bool, device,
                max_inner: int = 32) -> StepParams:
    """Level ``lvl``'s StepParams for ``gn_fixed`` (``gn``) or ``lm``."""
    max_iter = opt.fixed_iters[lvl] + 1 if gn else opt.max_its_per_lvl[lvl]
    return StepParams(
        gn=gn, max_iter=max_iter, max_inner=max_inner, conv_eps=opt.convergence_eps[lvl],
        flat_below=2.0 - opt.convergence_eps[lvl], step_min=opt.step_size_min[lvl],
        success=opt.lambda_success_fac, fail=opt.lambda_fail_fac,
        lam0=opt.lambda_initial[lvl] + 1e-5 if gn else opt.lambda_initial[lvl],
        pows=_fail_table(opt.lambda_fail_fac, (max_iter if gn else max_inner) + 1, device),
        impl=opt.solve6_impl,
    )


def _system(sums: torch.Tensor) -> LevelSystem:
    """The normalized system of the (B, 46) K3 output rows ``sums``, in
    tensors of its own (the next evaluation overwrites ``sums``)."""
    return _normalize_sums(*(x.clone() for x in _lane_outputs(sums)))


def _power(pows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,) ``fail ** k`` from the table, k clamped into it."""
    return pows[k.clamp(0, pows.shape[0] - 1).long()]


def _assign(dst: LevelState, src: LevelState) -> LevelState:
    """``src``'s values written into ``dst``'s tensors; returns ``dst``."""
    for d, s in zip(_tree_leaves(dst), _tree_leaves(src)):
        d.copy_(s)
    return dst


def _with_candidate(state: LevelState, live, p: StepParams, n_live) -> LevelState:
    """The tail of every step: the lanes ``live`` (B,) take one more try
    (lm) and their next candidate, the damped solve of the kept system;
    the others keep theirs and stop.  Writes the live count to ``n_live``
    where given."""
    new = _damped_step(state.sys, state.lam, state.R, state.t, p.impl)
    inc, Rn, tn = (_where_tree(live, a, b) for a, b in zip(new, (state.inc, state.Rn, state.tn)))
    tries = state.tries if p.gn else torch.where(live, state.tries + 1, state.tries)
    if n_live is not None:
        n_live.copy_(live.sum(dtype=torch.int32).reshape(1))
    return state._replace(Rn=Rn, tn=tn, inc=inc, tries=tries, active=live)


def solver_start_ref(R0, t0, sums, p: StepParams, n_live=None) -> LevelState:
    """Plain version of ``solver_start``: a level's state from the start
    pose (R0 (B, 3, 3), t0 (B, 3)): for lm the system of the first
    evaluation ``sums`` (B, 46) at (R0, t0), for gn_fixed the zero system at
    err = inf (``sums`` unread), whose damped solve is inc = 0, so that the
    first evaluation is of (R0, t0) and always accepts; then the first
    candidate, in new tensors."""
    b, dev = R0.shape[0], R0.device
    zero_i = torch.zeros(b, dtype=torch.int32, device=dev)
    if p.gn:
        zero_f = torch.zeros(b, dtype=torch.float32, device=dev)
        sys = LevelSystem(
            err=torch.full((b,), float("inf"), device=dev),
            A=torch.zeros((b, 6, 6), device=dev), g=torch.zeros((b, 6), device=dev),
            info=ResidualInfo(zero_i, zero_i, zero_f, zero_f),
        )
    else:
        sys = _system(sums)
    state = LevelState(
        R=R0, t=t0, Rn=R0, tn=t0, inc=torch.zeros((b, 6), device=dev), sys=sys,
        lam=torch.full((b,), p.lam0, dtype=torch.float32, device=dev),
        iteration=zero_i, tries=zero_i, active=None,
    )
    return _assign(_empty_state(b, dev), _with_candidate(state, zero_i < p.max_iter, p, n_live))


def solver_step_ref(state: LevelState, sums, p: StepParams, n_live=None) -> LevelState:
    """Plain version of ``solver_step``: one evaluation's outcome for every
    active lane, from its K3 outputs ``sums`` (B, 46) at (Rn, tn).  Accept
    on error decrease (take the candidate and its system).  lm
    (optimizer.cpp:235-311): lambda *= success factor on accept (0 at or
    below 0.2), converge when err / last_err > eps; on reject lambda to 0.2
    from 0, else *= fail ** tries, stop the level when |inc|^2 <= step_min;
    the iteration advances on accept, on a small step or after max_inner
    tries.  gn_fixed (revo_tpu/solver.py ``_gn_level_fixed``): from the
    second evaluation, lambda *= success factor on accept, on reject to at
    least 0.2 and then *= fail ** (rejects in a row); stop on accept when
    err / last_err > eps, on reject when the step is tiny or the candidate
    barely worse (< 2 - eps).  Inactive lanes are left as they are.
    Writes the result into ``state``'s tensors and returns ``state``."""
    act = state.active
    sys_n = _system(sums)
    err, last = sys_n.err, state.sys.err
    ratio = err / torch.clamp(last, min=1e-30)
    accept = err < last
    small = ~(sq_norm6(state.inc) > p.step_min)
    take = act & accept
    R, t, sys = (_where_tree(take, a, b)
                 for a, b in zip((state.Rn, state.tn, sys_n), (state.R, state.t, state.sys)))
    lam, it, tries = state.lam, state.iteration, state.tries
    if p.gn:
        tries = torch.where(act, torch.where(accept, 0, tries + 1), tries)
        upd = act & (it > 0)  # evaluation 0 is of the start pose
        lam = torch.where(upd, torch.where(
            accept, lam * p.success,
            torch.where(lam < 0.2, torch.clamp(lam * p.fail, min=0.2), lam * _power(p.pows, tries)),
        ), lam)
        done = upd & torch.where(accept, ratio > p.conv_eps, small | (ratio < p.flat_below))
        it = torch.where(act, it + 1, it)
        live = act & ~done & (it < p.max_iter)
    else:
        lam = torch.where(act, torch.where(
            accept, torch.where(lam <= 0.2, 0.0, lam * p.success),
            torch.where(lam == 0.0, 0.2, lam * _power(p.pows, tries)),
        ), lam)
        stop = act & ((accept & (ratio > p.conv_eps)) | (~accept & small))
        it = torch.where(stop, p.max_iter, it)
        nxt = act & (accept | small | (tries >= p.max_inner))
        it = torch.where(nxt, torch.clamp(it + 1, max=p.max_iter), it)
        tries = torch.where(nxt, 0, tries)
        live = act & (it < p.max_iter)
    new = state._replace(R=R, t=t, sys=sys, lam=lam, iteration=it, tries=tries)
    return _assign(state, _with_candidate(new, live, p, n_live))


def _empty_state(b: int, dev) -> LevelState:
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    return LevelState(
        R=torch.empty((b, 3, 3), **f), t=torch.empty((b, 3), **f),
        Rn=torch.empty((b, 3, 3), **f), tn=torch.empty((b, 3), **f),
        inc=torch.empty((b, 6), **f),
        sys=LevelSystem(
            err=torch.empty(b, **f), A=torch.empty((b, 6, 6), **f), g=torch.empty((b, 6), **f),
            info=ResidualInfo(torch.empty(b, **i), torch.empty(b, **i), torch.empty(b, **f),
                              torch.empty(b, **f)),
        ),
        lam=torch.empty(b, **f), iteration=torch.empty(b, **i), tries=torch.empty(b, **i),
        active=torch.empty(b, dtype=torch.bool, device=dev),
    )


def _launch_step(state: LevelState, sums, p: StepParams, n_live, R0=None, t0=None) -> None:
    """One ``revo_solver_step`` launch (csrc/solver.cu) over the B lanes of
    ``state``, updated in place; ``R0`` given: the level's start."""
    dev = state.R.device
    if dev.type != "cuda":
        raise ValueError(f"solver_step: unsupported device {dev}")
    if p.impl != "ldlt":
        raise ValueError(f"solver_step: the kernel solves by LDL^T; solve6_impl {p.impl!r} "
                         "takes the plain step (solver_step_ref)")
    b = state.R.shape[0]
    if any(not x.is_contiguous() or x.shape[0] != b or x.device != dev
           for x in _tree_leaves(state)):
        raise ValueError("solver_step: the state must be solver_start's contiguous tensors")
    if sums is not None and (sums.shape != (b, 46) or sums.dtype != torch.float32
                             or not sums.is_contiguous() or sums.device != dev):
        raise ValueError(f"solver_step: sums want contiguous float32 ({b}, 46) on {dev}")
    R0_s = t0_s = 0
    if R0 is not None:
        R0, R0_s = _lane_operand(R0, b, (3, 3), (torch.float32,), dev, "R0")
        t0, t0_s = _lane_operand(t0, b, (3,), (torch.float32,), dev, "t0")
    info = state.sys.info
    kernels.launch(
        "revo_solver_step", sums, state.R, state.t, state.Rn, state.tn, state.inc,
        state.sys.err, state.sys.A, state.sys.g, info.good, info.bad, info.sum_error_weighted,
        info.sum_error_unweighted, state.lam, state.iteration, state.tries, state.active, n_live,
        p.pows, p.pows.shape[0], R0, R0_s, t0, t0_s, b, int(R0 is not None), int(p.gn),
        p.max_iter, p.max_inner, p.conv_eps, p.flat_below, p.step_min, p.success, p.fail, p.lam0,
    )
    solver_step.launches += 1


def _tree_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _tree_leaves(x)]


def solver_start(R0, t0, sums, p: StepParams, n_live=None) -> LevelState:
    """A level's LevelState from its start pose and (lm) the K3 outputs of
    the first evaluation there, as ``solver_start_ref`` computes it.  CPU
    tensors: the plain version; CUDA tensors: one ``revo_solver_step``
    launch in its start mode, into new state tensors.  ``n_live`` (1,)
    int32, where given, receives the count of live lanes."""
    if R0.device.type == "cpu":
        return solver_start_ref(R0, t0, sums, p, n_live)
    state = _empty_state(R0.shape[0], R0.device)
    _launch_step(state, sums, p, n_live, R0, t0)
    return state


def solver_step(state: LevelState, sums, p: StepParams, n_live=None) -> LevelState:
    """One evaluation's step over every lane, as ``solver_step_ref``
    computes it, written into ``state``'s tensors in place (the next
    candidate into the Rn, tn that ``residual_lgsx`` reads next); returns
    ``state``.  CPU tensors: the plain version; CUDA tensors: one
    ``revo_solver_step`` launch.  ``launches`` counts the kernel's launches,
    the start's included."""
    if state.R.device.type == "cpu":
        return solver_step_ref(state, sums, p, n_live)
    _launch_step(state, sums, p, n_live)
    return state


solver_step.launches = 0


def _steppers(p: StepParams):
    """(start, step) of a level: the kernel for solve6_impl "ldlt", the
    plain versions on any device for "linalg", whose
    ``torch.linalg.solve_ex`` rounds as cuSOLVER does, which no hand
    kernel repeats."""
    if p.impl == "ldlt":
        return solver_start, solver_step
    return solver_start_ref, solver_step_ref


# lm evaluations between two of the host's reads of the live-lane count.
LM_CHUNK = 4


class _LiveCounts:
    """lm's live-lane counts on the host.  After each chunk of LM_CHUNK
    evaluations the count that the last step wrote is queued to pinned
    memory (two slots, one CUDA event each), and the host reads chunk c -
    1's only once chunk c is queued, so its wait never leaves the device
    idle.  ``lm_level_batched.host_reads`` counts the reads."""

    def __init__(self, n_live: torch.Tensor):
        self.n_live = n_live
        cuda = n_live.device.type == "cuda"
        self.host = torch.empty(2, dtype=torch.int32, pin_memory=cuda)
        self.events = [torch.cuda.Event(), torch.cuda.Event()] if cuda else None
        self.posted = 0

    def post_and_read_previous(self):
        """Queue the current count; return the one queued before it (None
        after the first chunk)."""
        slot = self.posted % 2
        self.host[slot:slot + 1].copy_(self.n_live, non_blocking=True)
        if self.events is not None:
            self.events[slot].record()
        self.posted += 1
        if self.posted < 2:
            return None
        if self.events is not None:
            self.events[1 - slot].synchronize()
        lm_level_batched.host_reads += 1
        return int(self.host[1 - slot])


def _evaluate(ops, R, t, edge_distance, opt: OptimizerConfig, active, out) -> torch.Tensor:
    """The K3 outputs (B, 46) of the lanes ``active`` (B,) selects (None:
    all) at (R, t) into ``out``, whose other rows stay as they were: one
    fused K3 launch on operands ``lgsx.lane_operands`` checked once per
    level.  Returns ``out``."""
    residual_lgsx_lanes(ops, R, t, edge_distance, opt.huber_edge, opt.use_edge_filter, active,
                        out)
    return out


# How a level may run on the card (``level_route``): the level kernel, or
# the two-launch loop (``residual_lgsx`` + ``solver_step`` an evaluation),
# which a caller picks to compare the two.
LEVEL_FORMS = ("kernel", "launches")
# Blocks a lane the level kernel may take, largest first (csrc/level.cu:
# up to 8, the portable cluster size).
LEVEL_CLUSTERS = (8, 4, 2, 1)
# Waves of clusters the level kernel's lanes may take, by solver: gn_fixed's
# lanes all run the same evaluations, so a second wave doubles the time;
# lm's lanes leave at different evaluations, and a second wave of larger
# clusters fills the SMs that early lanes free (every size timed at B = 1,
# 8, 16, 32 in chip_smoke phase 24 (f); PERF.md section 6).
LEVEL_WAVES = {"gn_fixed": 1, "lm": 2}


def level_route(device, impl: str, form: str = "kernel") -> str:
    """How a level runs on ``device``: "kernel" (one ``solve_level_kernel``
    launch: a CUDA device, solve6_impl "ldlt" and the default form),
    "launches" (the two-launch loop on the card, chosen by the caller) or
    "plain" (the loop with the plain step: the CPU, or solve6_impl
    "linalg" on any device).  Raises ValueError for another device or
    form."""
    device = torch.device(device)
    if form not in LEVEL_FORMS:
        raise ValueError(f"unknown level form {form!r}; one of {LEVEL_FORMS}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"solver: unsupported device {device}")
    if device.type == "cpu" or impl != "ldlt":
        return "plain"
    return form


@functools.lru_cache(maxsize=None)
def level_cluster(device: torch.device, layout: int, lanes: int, gn: bool) -> int:
    """Blocks a lane of ``solve_level_kernel`` takes on ``device`` for table
    ``layout``: the largest of LEVEL_CLUSTERS of which the card holds
    ``lanes`` clusters in LEVEL_WAVES of the solver (``gn``: gn_fixed, else
    lm), else 1.  The cluster size changes no bit of the result."""
    waves = LEVEL_WAVES["gn_fixed" if gn else "lm"]
    for cluster in LEVEL_CLUSTERS:
        held = kernels.call("revo_solve_level_clusters", layout, cluster, device=device)
        if held < 0:
            raise RuntimeError(f"solve_level_kernel: CUDA error {-held} counting clusters")
        if held * waves >= lanes:
            return cluster
    return LEVEL_CLUSTERS[-1]


LEVEL_ATTRIBUTES = ("registers", "local_bytes", "shared_bytes", "threads", "max_threads")


def level_attributes(device, layout: int) -> dict:
    """The built level kernel's attributes for table ``layout``
    (``cudaFuncGetAttributes``): registers a thread, local memory bytes a
    thread (spills included), static shared memory bytes and threads a
    block, and the most threads a block the build admits."""
    out = {}
    for which, name in enumerate(LEVEL_ATTRIBUTES):
        value = kernels.call("revo_solve_level_attr", layout, which, device=torch.device(device))
        if value < 0:
            raise RuntimeError(f"solve_level_kernel: CUDA error {-value} reading {name}")
        out[name] = value
    return out


def solve_level_kernel(ops: LaneOperands, R0, t0, edge_distance, opt: OptimizerConfig,
                       p: StepParams, _cluster=None, check=None):
    """One pyramid level of B lanes in one launch of ``revo_solve_level``
    (csrc/level.cu): per lane, one thread-block cluster evaluates and steps
    until the lane's own exit or the cap, lm's start evaluation included,
    as ``solve_level_ref`` computes it; the two-launch loop's result bit
    for bit.  ``ops``: the level's operands (``lane_operands`` on the card),
    R0 (B, 3, 3), t0 (B, 3) the start poses, ``p`` the schedule
    (solve6_impl "ldlt").  ``check``, an ``InitCheckBlock`` of the level's
    lanes, runs the tracker's init check before the level's start in the
    same launch (``init_check``'s bits, written into its outputs), and the
    level starts from its choice.  Returns (the final LevelState in new
    tensors, the evaluations each lane ran (B,) int32).  The cluster size
    follows from the lanes, the solver and the card (``level_cluster``);
    ``_cluster`` (1-8) lets a comparison force one.  A launch the card
    refuses raises; nothing falls back.  ``launches`` counts the launches,
    ``layout_launches`` the same by table layout, ``check_launches`` those
    that carried an init check, and ``evaluations`` holds the last
    launch's counts."""
    dev = ops.quad.device
    if ops.scratch is None or dev.type != "cuda":
        raise ValueError(f"solve_level_kernel: unsupported device {dev}")
    if p.impl != "ldlt":
        raise ValueError(f"solve_level_kernel: the kernel solves by LDL^T; solve6_impl "
                         f"{p.impl!r} takes the plain step")
    b, cam = ops.lanes, ops.cam
    R0, R0_s = _lane_operand(R0, b, (3, 3), (torch.float32,), dev, "R0")
    t0, t0_s = _lane_operand(t0, b, (3,), (torch.float32,), dev, "t0")
    layout = table_layout(ops.quad)
    cluster = level_cluster(dev, layout, b, bool(p.gn)) if _cluster is None else int(_cluster)
    state = _empty_state(b, dev)
    evals = torch.empty(b, dtype=torch.int32, device=dev)
    quad_s, pts_s, valid_s = ops.strides
    n_pts = ops.cloud.points.shape[-2]
    # The init check's operands (a null structure: none).
    struct, struct_s, ic_edge, ic_filter, ic_norm, margin, use_eye, costs = (
        None, 0, 0.0, 0, 0, 0.0, None, None)
    if check is not None:
        struct, struct_s = _lane_operand(check.struct, b, (cam.height, cam.width, 3),
                                         (torch.float32,), dev, "struct")
        use_eye, costs = check.use_eye, check.costs
        if (use_eye.shape != (b,) or use_eye.dtype != torch.bool or costs.shape != (b, 2)
                or costs.dtype != torch.float32 or use_eye.device != dev
                or costs.device != dev
                or not (use_eye.is_contiguous() and costs.is_contiguous())):
            raise ValueError(f"solve_level_kernel: the check's outputs want contiguous bool "
                             f"({b},) and float32 ({b}, 2) on {dev}")
        ic_edge, ic_filter = check.edge_distance, int(bool(check.use_edge_filter))
        ic_norm, margin = int(bool(check.normalized)), check.margin
    info = state.sys.info
    kernels.launch(
        "revo_solve_level", ops.quad, layout, quad_s, ops.cloud.points, pts_s, ops.cloud.valid,
        valid_s, R0, R0_s, t0, t0_s, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
        edge_distance, opt.huber_edge, int(bool(opt.use_edge_filter)), n_pts, b, ops.scratch[0],
        state.R, state.t, state.Rn, state.tn, state.inc, state.sys.err, state.sys.A, state.sys.g,
        info.good, info.bad, info.sum_error_weighted, info.sum_error_unweighted, state.lam,
        state.iteration, state.tries, state.active, evals, p.pows, p.pows.shape[0], int(p.gn),
        p.max_iter, p.max_inner, p.conv_eps, p.flat_below, p.step_min, p.success, p.fail,
        p.lam0, struct, struct_s, ic_edge, ic_filter, ic_norm, margin, use_eye, costs, cluster,
    )
    solve_level_kernel.launches += 1
    solve_level_kernel.layout_launches[layout] += 1
    solve_level_kernel.check_launches += check is not None
    solve_level_kernel.evaluations = evals
    return state, evals


solve_level_kernel.launches = 0
solve_level_kernel.check_launches = 0  # launches that ran the init check first
# Launches by table layout (``ops.lgsx.table_layout``'s code), beside the total.
solve_level_kernel.layout_launches = [0] * len(residual_lgsx.layout_launches)
solve_level_kernel.evaluations = None  # the last launch's (B,) counts, for a caller's accounting


def solve_level_ref(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int, gn: bool,
                    max_inner: int = 32, check=None):
    """Plain version of ``solve_level_kernel``, its schedule as torch ops on
    any device: ``check`` given, ``init_check_ref`` first (its outputs
    written into the block's) and the level from its choice; then each lane
    evaluates (``residual_lgsx_batched_ref``) and steps
    (``solver_step_ref``) until its own exit or the cap (lm: its start
    evaluation, then at most max_its * max_inner; gn_fixed: at most
    fixed_iters + 1), and counts its evaluations; the level ends when no
    lane is left.  Operands as ``lm_level_batched`` takes them.  Returns
    (the final LevelState, evaluations (B,) int32)."""
    edge_dist = opt.edge_distance_lvl[lvl]
    b, dev = R0.shape[0], R0.device
    if check is not None:
        R0, t0 = _run_check(init_check_ref, check, cloud, cam, R0, t0)
    p = step_params(opt, lvl, gn, dev, max_inner)
    sums = torch.zeros((b, 46), dtype=torch.float32, device=dev)
    evals = torch.zeros(b, dtype=torch.int32, device=dev)

    def evaluate(R, t, active):
        residual_lgsx_batched_ref(quad, cloud, cam, R, t, edge_dist, opt.huber_edge,
                                  opt.use_edge_filter, active, sums)
        return sums

    if gn:
        state = solver_start_ref(R0, t0, None, p)
    else:
        state = solver_start_ref(R0, t0, evaluate(R0, t0, None), p)
        evals += 1
    for _ in range(p.max_iter if gn else p.max_iter * max_inner):
        act = state.active.clone()
        if not bool(act.any()):
            break
        evals += act.to(torch.int32)
        state = solver_step_ref(state, evaluate(state.Rn, state.tn, act), p)
    return state, evals


def level_state(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int, gn: bool,
                max_inner: int = 32, _form: str = "kernel", check=None) -> LevelState:
    """The final LevelState of one pyramid level over B lanes, gn_fixed's
    (``gn``) or lm's, routed by ``level_route``: on the card with
    solve6_impl "ldlt" one ``solve_level_kernel`` launch; with ``_form``
    "launches" (a caller's comparison), on the CPU and for "linalg" the
    loop of one ``residual_lgsx`` (the plain version on the CPU) and one
    step an evaluation, the step the kernel's (``solver_step``) or the plain
    one (``_steppers``).  gn_fixed's loop runs its fixed_iters + 1
    evaluations and reads nothing on the host; lm's reads a live-lane count
    once per LM_CHUNK evaluations, one chunk late (``_LiveCounts``), so it
    runs up to 2 LM_CHUNK - 1 evaluations past its slowest lane, which find
    every lane stopped and change nothing; at most max_its * max_inner.
    The kernel leaves each lane at its own exit, as JAX's while_loop does;
    the two give the same bits.  ``check``, an ``InitCheckBlock``: the
    tracker's init check before the level's start, inside the kernel's
    launch, else one ``init_check`` call (its plain version on the CPU)
    first; the level starts from its choice either way."""
    edge_dist = opt.edge_distance_lvl[lvl]
    b, dev = R0.shape[0], R0.device
    route = level_route(dev, opt.solve6_impl, _form)
    p = step_params(opt, lvl, gn, dev, max_inner)
    ops = lane_operands(quad, cloud, cam, b)
    if route == "kernel":
        return solve_level_kernel(ops, R0, t0, edge_dist, opt, p, check=check)[0]
    if check is not None:
        R0, t0 = _run_check(init_check, check, cloud, cam, R0, t0)
    start, step = _steppers(p)
    sums = torch.empty((b, 46), dtype=torch.float32, device=dev)
    if gn:
        state = start(R0, t0, None, p)
        for _ in range(p.max_iter):
            state = step(state, _evaluate(ops, state.Rn, state.tn, edge_dist, opt, state.active,
                                          sums), p)
        return state
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    counts = _LiveCounts(n_live)
    state = start(R0, t0, _evaluate(ops, R0, t0, edge_dist, opt, None, sums), p, n_live)
    for n in range(1, p.max_iter * max_inner + 1):
        state = step(state, _evaluate(ops, state.Rn, state.tn, edge_dist, opt, state.active,
                                      sums), p, n_live)
        if n % LM_CHUNK == 0 and counts.post_and_read_previous() == 0:
            break
    return state


def lm_level_batched(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int,
                     max_inner: int = 32, _form: str = "kernel", check=None):
    """One pyramid level of LM (Optimizer::trackFrames,
    optimizer.cpp:235-311) over B lanes (quad (B, H*W, C), the keyframe level's
    table as ``ops.lgsx.table_layout`` takes it; cloud points
    (B, P, 3), any operand shareable by ``expand``; R0 (B, 3, 3), t0 (B, 3)),
    with the rules of ``solver_step_ref``.  ``max_inner`` bounds the
    reference's unbounded retry loop.  Every evaluation is one try of every
    active lane: the JAX package's nested while loops, vmapped, as one
    loop over the LevelState in device memory (``level_state``: on the
    card one kernel launch; ``check``: the init check first).  Returns (R,
    t, last_err, info), each with the lane axis."""
    state = level_state(quad, cloud, cam, R0, t0, opt, lvl, False, max_inner, _form, check)
    return state.R, state.t, state.sys.err, state.sys.info


lm_level_batched.host_reads = 0


def gn_level_fixed_batched(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int,
                           _form: str = "kernel", check=None):
    """Bounded branchless LM over B lanes, the JAX package's batched fast
    path (solver._gn_level_fixed and its batching rule, solver.py:609-697),
    with the rules of ``solver_step_ref``: at most fixed_iters[lvl] + 1
    evaluations, the first of which evaluates the initial pose
    (``level_state``: on the card one kernel launch, each lane leaving at
    its own exit; the loop form runs all of them, and those after a lane
    stopped change nothing; ``check``: the init check first).  Returns (R,
    t, err, info), each with the lane axis."""
    state = level_state(quad, cloud, cam, R0, t0, opt, lvl, True, _form=_form, check=check)
    return state.R, state.t, state.sys.err, state.sys.info


def _one_lane(fn, quad, cloud, cam, R0, t0, *args):
    """``fn``, a batched solver, at B = 1 on one lane's operands; returns
    that lane's outputs."""
    one = EdgeCloud(points=cloud.points[None], valid=cloud.valid[None], count=None)
    return lane(fn(quad[None], one, cam, R0[None], t0[None], *args), 0)


def lm_level(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int, max_inner: int = 32):
    """``lm_level_batched`` for one lane: quad (H*W, C), cloud (P, 3),
    R0 (3, 3), t0 (3,).  Returns (R, t, last_err, info)."""
    return _one_lane(lm_level_batched, quad, cloud, cam, R0, t0, opt, lvl, max_inner)


def gn_level_fixed(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int):
    """``gn_level_fixed_batched`` for one lane.  Returns (R, t, err, info)."""
    return _one_lane(gn_level_fixed_batched, quad, cloud, cam, R0, t0, opt, lvl)


def solve_level_batched(quad, cloud, cam, R0, t0, opt: OptimizerConfig, lvl: int, check=None):
    """Dispatch on OptimizerConfig.solver, over B lanes; ``check`` (an
    ``InitCheckBlock``) runs the tracker's init check before the level."""
    if opt.solver == "gn_fixed":
        return gn_level_fixed_batched(quad, cloud, cam, R0, t0, opt, lvl, check=check)
    if opt.solver == "lm":
        return lm_level_batched(quad, cloud, cam, R0, t0, opt, lvl, check=check)
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
    terms, ok = cost_terms(dt_img, cloud, cam, R, t, edge_distance, use_edge_filter)
    total = terms.to(torch.float64).sum(-1).to(torch.float32)
    if normalized:
        return total / torch.clamp(ok.sum(-1), min=1).to(torch.float32)
    return total


def cost_terms(dt_img, cloud, cam, R, t, edge_distance, use_edge_filter):
    """``eval_cost``'s terms, per point (..., P): the floor-sampled DT value
    where the point counts, else 0, and whether it counts."""
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
    return torch.where(ok, res, 0.0), ok


class InitCheck(NamedTuple):
    """The tracker's init check of B lanes (``init_check``)."""

    R: torch.Tensor  # (B, 3, 3) the level's starting pose
    t: torch.Tensor  # (B, 3)
    use_eye: torch.Tensor  # (B,) bool: the identity replaced (R0, t0)
    cost_eye: torch.Tensor  # (B,) float32 ``eval_cost`` at the identity
    cost: torch.Tensor  # (B,) at (R0, t0)


def init_check_ref(struct, cloud, cam, R0, t0, edge_distance, use_edge_filter, normalized,
                   margin) -> InitCheck:
    """Plain version of ``init_check``: ``eval_cost`` of the DT channel of
    ``struct`` (B, H, W, 3) at the identity and at (R0, t0), and the
    identity where its cost is below ``margin`` times the other."""
    b, dev = R0.shape[0], R0.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    zero = torch.zeros(3, device=dev).expand(b, 3)
    dt_img = struct[..., 2]

    def cost(R_, t_):
        return eval_cost(dt_img, cloud, cam, R_, t_, edge_distance, use_edge_filter, normalized)

    cost_eye, cost_0 = cost(eye, zero), cost(R0, t0)
    use_eye = cost_eye < margin * cost_0
    return InitCheck(torch.where(use_eye[:, None, None], eye, R0),
                     torch.where(use_eye[:, None], zero, t0), use_eye, cost_eye, cost_0)


def init_check(struct, cloud, cam, R0, t0, edge_distance, use_edge_filter, normalized,
               margin) -> InitCheck:
    """"DO NOT INIT WITH PREVIOUS TRANSFORM" (tracker.cpp:277-282) over B
    lanes: each lane starts from the identity where the floor-sampled DT
    cost there (``eval_cost``, divided by the count if ``normalized``) is
    below ``margin`` times the cost at (R0 (B, 3, 3), t0 (B, 3)).
    ``struct`` (B, H, W, 3) is the keyframe level's structure, ``cloud``
    the frame's cloud at that level (points (B, P, 3), valid (B, P)); any
    operand may be shared by the lanes through ``expand``.  CPU tensors:
    the plain version; CUDA tensors: one ``revo_init_check`` launch
    (csrc/solver.cu: a cluster of blocks a lane, csrc/initcheck.cuh's
    check, which the level kernel also runs), bit-equal to it, no host
    sync.  ``launches`` counts the kernel's launches.  On the main path the
    check runs inside the coarsest level's launch instead
    (``InitCheckBlock``); this call is the other routes'."""
    dev = R0.device
    if dev.type == "cpu":
        return init_check_ref(struct, cloud, cam, R0, t0, edge_distance, use_edge_filter,
                              normalized, margin)
    if dev.type != "cuda":
        raise ValueError(f"init_check: unsupported device {dev}")
    b, n_pts = R0.shape[0], cloud.points.shape[-2]
    struct, struct_s = _lane_operand(struct, b, (cam.height, cam.width, 3), (torch.float32,),
                                     dev, "struct")
    pts, pts_s = _lane_operand(cloud.points, b, (n_pts, 3), (torch.float32,), dev, "points")
    valid, valid_s = _lane_operand(cloud.valid, b, (n_pts,), (torch.bool,), dev, "valid")
    R0, R0_s = _lane_operand(R0, b, (3, 3), (torch.float32,), dev, "R0")
    t0, t0_s = _lane_operand(t0, b, (3,), (torch.float32,), dev, "t0")
    R = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    use_eye = torch.empty(b, dtype=torch.bool, device=dev)
    costs = torch.empty((b, 2), dtype=torch.float32, device=dev)
    kernels.launch(
        "revo_init_check", struct, struct_s, pts, pts_s, valid, valid_s, R0, R0_s, t0, t0_s,
        n_pts, b, cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy, edge_distance,
        int(bool(use_edge_filter)), int(bool(normalized)), margin, R, t, use_eye, costs,
    )
    init_check.launches += 1
    return InitCheck(R, t, use_eye, costs[:, 0], costs[:, 1])


init_check.launches = 0


class InitCheckBlock(NamedTuple):
    """The tracker's init check as a solver level takes it (``level_state``'s
    ``check``): ``init_check`` of the level's cloud and start poses against
    ``struct``, run before the level's start, which then starts from its
    choice.  ``init_check_block`` makes one."""

    struct: torch.Tensor  # (B, H, W, 3) the keyframe level's structure (channel 2: the DT)
    edge_distance: float
    use_edge_filter: bool
    normalized: bool
    margin: float
    use_eye: torch.Tensor  # (B,) bool, written: the identity replaced (R0, t0)
    costs: torch.Tensor  # (B, 2) float32, written: ``eval_cost`` at the identity, at (R0, t0)


def init_check_block(struct, lanes: int, edge_distance, use_edge_filter, normalized,
                     margin) -> InitCheckBlock:
    """An ``InitCheckBlock`` of ``lanes`` lanes (``struct`` (B or 1, H, W,
    3)), with new output tensors."""
    dev = struct.device
    return InitCheckBlock(struct, edge_distance, use_edge_filter, normalized, margin,
                          torch.empty(lanes, dtype=torch.bool, device=dev),
                          torch.empty((lanes, 2), dtype=torch.float32, device=dev))


def _run_check(fn, check: InitCheckBlock, cloud, cam, R0, t0):
    """``fn`` (``init_check`` or its plain version) of ``check`` on the
    level's cloud and start poses, its outputs written into the block's;
    returns the start poses it chose."""
    got = fn(check.struct, cloud, cam, R0, t0, check.edge_distance, check.use_edge_filter,
             check.normalized, check.margin)
    check.use_eye.copy_(got.use_eye)
    check.costs[:, 0].copy_(got.cost_eye)
    check.costs[:, 1].copy_(got.cost)
    return got.R, got.t
