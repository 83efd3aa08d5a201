"""Windowed multi-frame joint pose optimization, "windowed BA" (counterpart
of revo_tpu/parallel/windowed.py).

The reference declares this capability and never ships it (its
``windowedoptimization`` module is commented out of the build,
CMakeLists.txt:152-153, and ``Optimizer::bundleAdjustment`` is declared but
undefined, optimizer.h:164-165).

A window of W frames is optimized jointly: every ordered pair (i, j) of a
co-visibility set contributes edge-alignment residuals (frame j's edge cloud
projected into frame i's DT structure, the residual the tracker minimizes
pairwise), and one damped Gauss-Newton step couples all 6W pose unknowns
through the stacked normal equations

    H[i,i] += Ji^T W Ji,  H[i,j] += Ji^T W Jj,  ...  b[i] -= Ji^T W r

with the pair Jacobians chained from the tracker's relative-pose Jacobian
through the adjoint.  There are no landmark unknowns: edge-DT residuals
marginalize structure by construction.

The pair pass is batched over the pair axis: points and validity are
gathered by ``pair_j``, the (gx, gy, dt) structures are sampled by one
gather per bilinear tap over the stacked structs indexed by ``pair_i``
(``ops.interp.bilinear_sample_stacked``), and everything after is
elementwise over (pairs, points).  It is plain torch ops, as the JAX package
leaves this pass to XLA and runs no Pallas kernel here.

Precision.  Nothing here may round to TF32, whatever the caller's
``torch.backends`` flags say: 4x4 pose products are ``lie.matmul_fma``
(float64 FMA chains rounded as XLA's CPU dot), the 6x6 adjoint chaining is
an elementwise multiply and a sum, and the one large product, the sum over
up to 16384 points of J^T w [J r] per pair, is a float64 ``matmul`` rounded
to float32 afterwards (TF32 applies to float32 products only).  The dense
solve is ``torch.linalg.solve`` (float32 LU, as JAX leaves it to XLA's).

Rounding.  The projection decides bounds and bilinear weights, so it rounds
as jitted JAX on the CPU does: the W pose inverses are ``lie.inv_lu`` (on
the host, one small copy each way per evaluation, beside the flag read),
T_rel is an FMA chain, the point transform is ``apply_rt_cols`` and the
pinhole map ``scale_shift``; (u, v) then equal JAX's bit for bit.

Scatter order.  The block scatters are ``index_put_(accumulate=True)``:
atomic adds on the card, so where several pairs meet in one block their sum
differs in the last bits from run to run and from the CPU.  An accept/reject
tie of the LM schedule can then flip; no bit-equality is promised.

JAX's ``lax.while_loop`` is a Python loop here with one host read of the
accept / converged / small-step flags per evaluation, as ``solver.lm_level``
does it; the damping lambda lives on the host as a float32.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from revo_tpu_torch import lie
from revo_tpu_torch.config import CameraConfig, OptimizerConfig
from revo_tpu_torch.ops.interp import bilinear_sample_stacked
from revo_tpu_torch.ops.project import apply_rt_cols, scale_shift
from revo_tpu_torch.parallel.mesh import local_slots, psum, replicate, shard


class Window(NamedTuple):
    """Fixed-shape window state at one pyramid level."""

    structs: torch.Tensor  # (W, H, Wd, 3) per-frame DT structures (gx, gy, dt)
    points: torch.Tensor  # (W, P, 3) per-frame edge clouds
    valid: torch.Tensor  # (W, P) bool
    poses: torch.Tensor  # (W, 4, 4) world-from-frame poses


def _small_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched float32 ``A @ B`` for small matrices as a multiply and a sum:
    never a cuBLAS call, so never TF32."""
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def _pair_system(
    structs: torch.Tensor,
    points: torch.Tensor,
    valid: torch.Tensor,
    poses: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    cam: CameraConfig,
    huber: float,
    edge_distance: float,
):
    """Residuals of frame j's cloud in frame i's DT and the per-pose
    Jacobians, for all pairs (N,) at once.

    Let T_rel = T_i^-1 T_j (j-frame -> i-frame).  r(p) = DT_i(proj(T_rel p)),
    d r / d xi_rel is the tracker's 6-dof Jacobian.  With left-multiplicative
    world updates T_k <- exp(xi_k) T_k:
        d xi_rel / d xi_j = Ad(T_i^-1),   d xi_rel / d xi_i = -Ad(T_i^-1).
    Returns (Jr (N, P, 6) w.r.t. xi_rel, Ad (N, 6, 6), r, w, good (N, P)).
    """
    pi, pj = pair_i.long(), pair_j.long()
    T_inv = lie.inv_lu(poses)  # (W, 4, 4), once per frame, on the host
    Ti_inv = T_inv[pi]
    T_rel = lie.matmul_fma(Ti_inv, poses[pj])
    wx, wy, wz = apply_rt_cols(points[pj], T_rel[:, :3, :3], T_rel[:, :3, 3])
    pz = torch.where(wz == 0, 1e-12, wz)
    u = scale_shift(wx / pz, cam.fx, cam.cx)
    v = scale_shift(wy / pz, cam.fy, cam.cy)
    inb = (u > 1.0) & (v > 1.0) & (u < cam.width - 2.0) & (v < cam.height - 2.0)
    inb = inb & valid[pj]
    samp = bilinear_sample_stacked(structs, pi[:, None], u, v)
    r = samp[..., 2]
    good = inb & (r <= edge_distance)
    gx = cam.fx * samp[..., 0]
    gy = cam.fy * samp[..., 1]
    r_safe = torch.where(r == 0, 1.0, r)
    w = torch.where(r <= huber, 1.0, huber / r_safe) * good

    iz = 1.0 / pz
    iz2 = iz * iz
    px, py = wx, wy
    Jr = torch.stack(
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
    Ad = lie.adjoint_se3(Ti_inv[:, :3, :3], Ti_inv[:, :3, 3])
    return Jr, Ad, r, w, good


def _accumulate_pairs(
    window: Window,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    pair_w: torch.Tensor,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int,
    n_frames: int,
):
    """Block normal equations over a set of pairs: (H (W, W, 6, 6),
    b (W, 6), err ())."""
    Jr, Ad, r, w, good = _pair_system(
        window.structs, window.points, window.valid, window.poses,
        pair_i, pair_j, cam, opt.huber_edge, opt.edge_distance_lvl[lvl],
    )
    n = torch.clamp(good.sum(-1), min=1).to(torch.float32)  # (N,)
    # One float64 product per pair gives sum w J J^T (6x6), sum w J r (6)
    # and sum w r r: [J r]^T diag(w) [J r].
    Jr7 = torch.cat([Jr, r[..., None]], dim=-1).double()
    M = ((Jr7 * w[..., None].double()).transpose(-1, -2) @ Jr7).float()  # (N, 7, 7)
    A_rel = M[:, :6, :6] / n[:, None, None]
    g_rel = M[:, :6, 6] / n[:, None]
    # Relative-frame system, chained to world frames through Ad:
    # J_j = Jr Ad, J_i = -Jr Ad (w.r.t. world tangents).
    AdT = Ad.transpose(-1, -2)
    A_blks = _small_matmul(_small_matmul(AdT, A_rel), Ad) * pair_w[:, None, None]
    g_blks = _small_matmul(AdT, g_rel[..., None])[..., 0] * pair_w[:, None]
    errs = M[:, 6, 6] / n * pair_w

    pi, pj = pair_i.long(), pair_j.long()
    H = torch.zeros((n_frames, n_frames, 6, 6), dtype=torch.float32, device=Jr.device)
    b = torch.zeros((n_frames, 6), dtype=torch.float32, device=Jr.device)
    H.index_put_((pj, pj), A_blks, accumulate=True)
    H.index_put_((pi, pi), A_blks, accumulate=True)
    H.index_put_((pi, pj), -A_blks, accumulate=True)
    H.index_put_((pj, pi), -A_blks, accumulate=True)
    b.index_put_((pj,), g_blks, accumulate=True)
    b.index_put_((pi,), -g_blks, accumulate=True)
    return H, b, errs.sum()


def _window_step(poses, H, b, n_frames: int, lam):
    """Damped joint step: returns (updated poses, stacked tangent xi).

    Gauge freedom is removed by fixing frame 0: its rows and columns are
    masked and its diagonal pinned.  Damping is multiplicative
    (A_ii *= 1 + lambda, like the tracker, optimizer.cpp:261-262): plain GN
    overshoots on the nonconvex DT surface.  The sign convention is the
    tracker's: g accumulates +J^T w r and the update is exp(+H^-1 g) thanks
    to the negated DT gradients."""
    Hd = H.permute(0, 2, 1, 3).reshape(6 * n_frames, 6 * n_frames)
    bd = b.reshape(6 * n_frames)
    mask = torch.ones(6 * n_frames, dtype=H.dtype, device=H.device)
    mask[:6] = 0.0
    Hd = Hd * mask[:, None] * mask[None, :]
    diag = torch.diagonal(Hd)
    Hd = Hd + torch.diag(torch.where(mask > 0, diag * float(lam) + 1e-9, 1.0))
    bd = bd * mask
    xi = torch.linalg.solve(Hd, bd).reshape(n_frames, 6)
    xi = torch.where(torch.isfinite(xi), xi, 0.0)
    dR, dt = lie.exp_se3(xi)
    return lie.matmul_fma(lie.matrix_from_rt(dR, dt), poses), xi


def _lm_window(
    poses0,
    accumulate,
    n_frames: int,
    iters: int,
    lam0,
    success_fac: float = 0.5,
    fail_fac: float = 2.0,
    conv_eps: float = 0.999,
    step_min: float = 1e-16,
):
    """Accept/reject LM over the window (the tracker's schedule,
    optimizer.cpp:250-307, applied to the joint 6W-dof system): a step is
    kept only if the total windowed error drops; a rejected step restores
    the last accepted poses and re-solves the same system with escalated
    damping (lambda * fail_fac^try).  Exits on relative improvement >
    conv_eps, a rejected step below step_min, or ``iters`` evaluations.

    ``accumulate(poses) -> (H, b, err)`` abstracts the residual pass.
    Returns (poses, err, final lambda as a float)."""
    f32 = np.float32
    poses = poses0
    H, b, err = accumulate(poses0)
    lam, inc_try = f32(lam0), 0
    for _ in range(iters):
        poses_new, xi = _window_step(poses, H, b, n_frames, lam)
        Hn, bn, en = accumulate(poses_new)
        flags = torch.stack([
            en < err,
            en / torch.clamp(err, min=1e-30) > conv_eps,
            ~(torch.sum(xi * xi) > step_min),
        ])
        accept, converged, small_step = flags.tolist()  # the host sync
        if accept:
            poses, H, b, err = poses_new, Hn, bn, en
            lam = f32(0.0) if lam <= f32(0.2) else lam * f32(success_fac)
            inc_try = 0
            if converged:
                break
        else:
            inc_try += 1
            lam = f32(0.2) if lam == 0.0 else lam * f32(fail_fac) ** f32(inc_try)
            if small_step:
                break
    return poses, err, float(lam)


def make_pairs(n_frames: int, radius: int = 2, device=None):
    """Co-visibility pairs: all ordered (i, j), i != j, |i - j| <= radius,
    as (pair_i, pair_j int32, weights float32 of 1) on ``device``."""
    pairs = [
        (i, j) for i in range(n_frames) for j in range(n_frames)
        if i != j and abs(i - j) <= radius
    ]
    return (
        torch.tensor([i for i, _ in pairs], dtype=torch.int32, device=device),
        torch.tensor([j for _, j in pairs], dtype=torch.int32, device=device),
        torch.ones(len(pairs), dtype=torch.float32, device=device),
    )


def measure_overlap(
    window: Window, cam: CameraConfig, opt: OptimizerConfig, lvl: int = 0
) -> torch.Tensor:
    """(W, W) measured view overlap: the fraction of frame j's valid edge
    points that project in bounds into frame i and land within frame i's
    edge-distance band, which is exactly the residual support the joint
    optimizer will use, at the current pose estimates.  All W^2 ordered
    pairs go through one pair pass (build it at a coarse level: it holds
    W^2 x P lanes); the diagonal is zeroed."""
    n = window.poses.shape[0]
    idx = torch.arange(n, device=window.poses.device)
    ii, jj = torch.meshgrid(idx, idx, indexing="ij")
    _, _, _, _, good = _pair_system(
        window.structs, window.points, window.valid, window.poses,
        ii.reshape(-1), jj.reshape(-1), cam, opt.huber_edge, opt.edge_distance_lvl[lvl],
    )
    denom = torch.clamp(window.valid.sum(-1), min=1)[jj.reshape(-1)]
    O = (good.sum(-1).to(torch.float32) / denom.to(torch.float32)).reshape(n, n)
    return O * (1.0 - torch.eye(n, dtype=O.dtype, device=O.device))


def make_pairs_overlap(
    window: Window,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int = 0,
    min_overlap: float = 0.25,
    max_pairs: int | None = None,
):
    """Co-visibility pairs from measured view overlap instead of the fixed
    +-radius index ring: any pair whose overlap fraction clears
    ``min_overlap`` contributes, weighted by its overlap, so revisit pairs
    far apart in time (loop closures) enter the window while
    non-overlapping index neighbours drop out.

    Falls back to the +-1 ring when nothing clears the threshold (a window
    must stay connected to be solvable)."""
    dev = window.poses.device
    O = measure_overlap(window, cam, opt, lvl).cpu().numpy()
    n = O.shape[0]
    cand = sorted(
        ((float(O[i, j]), i, j) for i in range(n) for j in range(n)
         if i != j and O[i, j] >= min_overlap),
        reverse=True,
    )
    if max_pairs is not None:
        cand = cand[:max_pairs]
    if not cand:
        return make_pairs(n, radius=1, device=dev)
    # Keep the odometry chain connected even if some consecutive pair
    # dipped under the threshold (gauge connectivity).
    have = {(i, j) for _, i, j in cand}
    floor = float(np.median([w for w, _, _ in cand]))
    for k in range(n - 1):
        for (i, j) in ((k, k + 1), (k + 1, k)):
            if (i, j) not in have:
                cand.append((min(floor, max(float(O[i, j]), 0.05)), i, j))
    pw = np.array([w for w, _, _ in cand], np.float32)
    pw *= len(pw) / max(pw.sum(), 1e-6)  # mean weight 1, like the ring
    return (
        torch.tensor([i for _, i, _ in cand], dtype=torch.int32, device=dev),
        torch.tensor([j for _, _, j in cand], dtype=torch.int32, device=dev),
        torch.from_numpy(pw).to(dev),
    )


def _optimize_window_full(
    window: Window,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    pair_w: torch.Tensor,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int = 0,
    iters: int = 10,
    damping=1.0,
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """optimize_window returning (poses, err, final lambda): the lambda is
    the schedule's adapted damping at exit, which the coarse-to-fine loop
    carries into the next level (optimize_window_pyramid)."""
    n_frames = window.poses.shape[0]
    dev = window.poses.device
    pair_i, pair_j, pair_w = pair_i.to(dev), pair_j.to(dev), pair_w.to(dev)

    def accumulate(poses):
        return _accumulate_pairs(
            window._replace(poses=poses), pair_i, pair_j, pair_w, cam, opt, lvl, n_frames
        )

    return _lm_window(window.poses, accumulate, n_frames, iters, damping)


def optimize_window(
    window: Window,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    pair_w: torch.Tensor,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int = 0,
    iters: int = 10,
    damping=1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint LM over the window on the device of ``window``; returns
    (refined poses, final error).

    ``iters`` bounds the number of error evaluations after the first;
    ``damping`` is the initial lambda of the accept/reject schedule (see
    _lm_window)."""
    poses, err, _ = _optimize_window_full(
        window, pair_i, pair_j, pair_w, cam, opt, lvl=lvl, iters=iters, damping=damping
    )
    return poses, err


def optimize_window_sharded(window: Window, cam: CameraConfig, opt: OptimizerConfig, mesh,
                            axis: str = "pair", lvl: int = 0, iters: int = 10, radius: int = 2,
                            damping: float = 1.0) -> torch.Tensor:
    """Joint LM with the co-visibility pairs (``make_pairs``, padded with
    weight-0 lanes to a multiple of the axis size) sharded over ``axis`` of
    ``mesh``: each slot runs the pair pass of its share against a
    replicated window, and H, b and the error meet in ``psum`` before the
    accept/reject test, so every slot would take the same decisions; the
    schedule runs on the first slot's device.  Returns the refined poses
    there."""
    n_frames = window.poses.shape[0]
    home = local_slots(mesh, axis)[0]
    pi, pj, pw = make_pairs(n_frames, radius, device=home)
    pad = (-len(pi)) % mesh.shape[axis]
    pi = torch.cat([pi, torch.zeros(pad, dtype=torch.int32, device=home)])
    pj = torch.cat([pj, torch.ones(pad, dtype=torch.int32, device=home)])
    pw = torch.cat([pw, torch.zeros(pad, dtype=torch.float32, device=home)])
    shares = list(zip(replicate(window, mesh, axis), shard(pi, mesh, axis),
                      shard(pj, mesh, axis), shard(pw, mesh, axis)))

    def accumulate(poses):
        parts = [
            _accumulate_pairs(win._replace(poses=poses.to(win.poses.device)), i, j, w, cam,
                              opt, lvl, n_frames)
            for win, i, j, w in shares
        ]
        return tuple(psum(x, mesh, axis) for x in zip(*parts))

    poses, _, _ = _lm_window(window.poses.to(home), accumulate, n_frames, iters, damping)
    return poses


def keyframe_window(keyframes, lvl: int, poses: torch.Tensor) -> Window:
    """The Window of a keyframe list at one pyramid level: stacked DT
    structures and edge clouds (read where they live; pruned keyframes
    serve) with ``poses`` (K, 4, 4) on their device."""
    return Window(
        structs=torch.stack([k.structs[lvl] for k in keyframes]),
        points=torch.stack([k.frame.levels[lvl].cloud.points for k in keyframes]),
        valid=torch.stack([k.frame.levels[lvl].cloud.valid for k in keyframes]),
        poses=poses,
    )


def refine_keyframes(
    keyframes,
    cfg,
    radius: int = 2,
    iters_per_lvl=(6, 4, 4),
    damping: float = 1.0,
    pairs: str = "overlap",
    extra_pairs=None,
    poses0=None,
) -> np.ndarray:
    """Post-run windowed refinement over a keyframe list (the entry behind
    ``run --windowed-ba``).

    Builds per-level Windows from the retained Keyframes (DT structs and
    edge clouds already live on the keyframes' device; pruned keyframes
    serve, since gray / depth / edge images are not read) and runs
    coarse-to-fine joint LM over all keyframe poses, gauge-fixed at the
    oldest.  Returns refined world poses (K, 4, 4) as numpy.

    ``pairs``: "overlap" (default) derives the co-visibility set and its
    weights from measured view overlap at the coarsest level (revisit pairs
    enter, blind index neighbours drop; make_pairs_overlap); "ring" keeps
    the fixed +-radius index ring.

    ``extra_pairs``: optional [(i, j, weight), ...] co-visibility edges to
    add, in both directions: the hook for verified loop-closure pairs
    (loopclosure.close_loops), so a detected revisit enters the joint
    refinement as a residual edge and not only as a pose-graph constraint.
    ``poses0``: optional (K, 4, 4) initial world poses overriding the
    keyframes' own (e.g. loop-closure-corrected)."""
    cams = cfg.camera_pyramid()
    n_levels = cfg.pyramid.n_levels
    opt = cfg.tracker.optimizer
    dev = keyframes[0].T_w_k.device
    if poses0 is None:
        poses0 = np.stack([k.T_w_k.detach().cpu().numpy() for k in keyframes])
    poses0 = torch.from_numpy(np.asarray(poses0).astype(np.float32)).to(dev)
    windows = tuple(keyframe_window(keyframes, lvl, poses0) for lvl in range(n_levels))
    if pairs == "overlap":
        lvl_c = n_levels - 1  # coarsest: cheapest, widest basin
        pi, pj, pw = make_pairs_overlap(windows[lvl_c], cams[lvl_c], opt, lvl=lvl_c)
    else:
        pi, pj, pw = make_pairs(len(keyframes), radius, device=dev)
    if extra_pairs:
        have = set(zip(pi.tolist(), pj.tolist()))
        ei, ej, ew = [], [], []
        for i, j, w in extra_pairs:
            for a, b in ((int(i), int(j)), (int(j), int(i))):
                if a != b and (a, b) not in have:
                    ei.append(a)
                    ej.append(b)
                    ew.append(float(w))
                    have.add((a, b))
        if ei:
            pi = torch.cat([pi, torch.tensor(ei, dtype=torch.int32, device=dev)])
            pj = torch.cat([pj, torch.tensor(ej, dtype=torch.int32, device=dev)])
            pw = torch.cat([pw, torch.tensor(ew, dtype=torch.float32, device=dev)])
    poses, _ = optimize_window_pyramid(
        windows, pi, pj, pw, tuple(cams[:n_levels]), opt,
        iters_per_lvl=iters_per_lvl, damping=damping,
    )
    return poses.cpu().numpy()


def optimize_window_pyramid(
    windows,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    pair_w: torch.Tensor,
    cams,
    opt: OptimizerConfig,
    iters_per_lvl=(6, 6, 10),
    damping: float = 1.0,
    carry_damping: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine windowed optimization.

    ``windows[lvl]`` / ``cams[lvl]`` index pyramid levels (0 = finest, like
    the tracker); optimization runs from the coarsest level down to level
    0, each level starting from the previous level's refined poses: the
    pull-in strategy of the coarse-to-fine tracker (tracker.cpp:324-340)
    applied to the joint window problem.  All levels share the pose
    unknowns, so only the poses are chained.

    ``carry_damping`` (default): each finer level starts from the coarser
    level's exit lambda instead of resetting to ``damping``: the schedule
    has already adapted to the window's conditioning.  The exit lambda can
    be 0 (repeated-success decay); the schedule's 0 -> 0.2 reject jump
    re-enters safely."""
    n_levels = len(windows)
    poses = windows[n_levels - 1].poses
    err = torch.zeros((), dtype=torch.float32, device=poses.device)
    lam = damping
    for lvl in range(n_levels - 1, -1, -1):
        poses, err, lam_out = _optimize_window_full(
            windows[lvl]._replace(poses=poses), pair_i, pair_j, pair_w, cams[lvl], opt,
            lvl=lvl, iters=iters_per_lvl[min(lvl, len(iters_per_lvl) - 1)], damping=lam,
        )
        if carry_damping:
            lam = lam_out
    return poses, err
