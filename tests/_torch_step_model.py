"""A numpy float32 model of the level kernel's step (csrc/solver.cuh
``step_lane_warp``) entry by entry, jax-free.

The kernel spreads one lane's step over the 32 lanes of a warp: warp lane k
takes entries k and k + 32 of the normalised system, lanes i < 6 row i of
L (every lane each pivot), every lane the triangular solves and exp's
scalars, lanes k < 9 entry k of exp's R and V and of the composed rotation,
lanes i < 3 entry i of exp's t and of the composed translation.  This model
computes each of those entries by the same operations in the same order
(one numpy float32 or float64 operation for each intrinsic of the kernel),
so that a test can hold the decomposition to ``solver.solver_step_ref``.
sin and cos come from PyTorch, as the plain step takes them.
"""
import numpy as np
import torch

F = np.float32
D = np.float64


def _sin(x):
    return F(torch.sin(torch.tensor([x], dtype=torch.float32))[0].item())


def _cos(x):
    return F(torch.cos(torch.tensor([x], dtype=torch.float32))[0].item())


def fma_chain3(a0, b0, a1, b1, a2, b2):
    acc = F(D(a0) * D(b0))
    acc = F(D(acc) + D(a1) * D(b1))
    return F(D(acc) + D(a2) * D(b2))


def dot3r(r, v):
    return (r[2] * v[2] + r[1] * v[1]) + r[0] * v[0]


def clamp_min(x, m):
    return x if np.isnan(x) else max(x, m)


def sq_norm6(v):
    p = [v[k] * v[k] for k in range(6)]
    return ((p[0] + p[4]) + (p[1] + p[5])) + (p[2] + p[3])


def exp_coeffs(x):
    w0, w1, w2 = x[3], x[4], x[5]
    th2 = (w0 * w0 + w1 * w1) + w2 * w2
    th = np.sqrt(th2)
    small = th2 < F(1e-8)
    ts = F(1.0) if small else th
    sn, cs = _sin(ts), _cos(ts)
    a = F(1.0) - th2 * (F(1.0) / F(6.0)) if small else sn / ts
    b = F(0.5) - th2 * (F(1.0) / F(24.0)) if small else (F(1.0) - cs) / (ts * ts)
    c = F(1.0 / 6.0) - th2 * (F(1.0) / F(120.0)) if small else (ts - sn) / ((ts * ts) * ts)
    return a, b, c


def hat(x):
    w0, w1, w2 = x[3], x[4], x[5]
    z = F(0.0)
    return [z, -w2, w1, w2, z, -w0, -w1, w0, z]


def exp_entry(W, k, a, b, c):
    i, j = divmod(k, 3)
    W2k = fma_chain3(W[3 * i], W[j], W[3 * i + 1], W[3 + j], W[3 * i + 2], W[6 + j])
    eye = F(1.0) if k % 4 == 0 else F(0.0)
    return (eye + a * W[k]) + b * W2k, (eye + b * W[k]) + c * W2k


def ldlt_pivot(Ajj, lam, Lj, d, j):
    s = Ajj + Ajj * lam
    for k in range(j):
        s = s - (Lj[k] * Lj[k]) * d[k]
    return F(1e-30) if abs(s) < F(1e-30) else s


def ldlt_entry(Aij, Li, Lj, d, j):
    t = Aij + F(0.0)
    for k in range(j):
        t = t - (Li[k] * Lj[k]) * d[k]
    return t / d[j]


def ldlt_solve(L, d, g):
    y = [F(0.0)] * 6
    for i in range(6):
        t = g[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t
    x = [F(0.0)] * 6
    for i in range(5, -1, -1):
        t = y[i] / d[i]
        for k in range(i + 1, 6):
            t = t - L[k][i] * x[k]
        x[i] = t
    return [v if np.isfinite(v) else F(0.0) for v in x]


def rules(err_n, err, inc, pows, p, lam, it, tries):
    """(live, accept, lam, it, tries) of a step after the start."""
    ratio = err_n / clamp_min(err, F(1e-30))
    accept = bool(err_n < err)
    small = not bool(sq_norm6(inc) > F(p.step_min))
    n_pows = len(pows)
    if p.gn:
        tries = 0 if accept else tries + 1
        pw = pows[min(max(tries, 0), n_pows - 1)]
        done = False
        if it > 0:
            if accept:
                lam = lam * F(p.success)
            elif lam < F(0.2):
                lam = clamp_min(lam * F(p.fail), F(0.2))
            else:
                lam = lam * pw
            done = bool(ratio > F(p.conv_eps)) if accept else (
                small or bool(ratio < F(p.flat_below)))
        it += 1
        return (not done) and it < p.max_iter, accept, lam, it, tries
    pw = pows[min(max(tries, 0), n_pows - 1)]
    if accept:
        lam = F(0.0) if lam <= F(0.2) else lam * F(p.success)
    else:
        lam = F(0.2) if lam == F(0.0) else lam * pw
    if (accept and ratio > F(p.conv_eps)) or (not accept and small):
        it = p.max_iter
    if accept or small or tries >= p.max_inner:
        it = min(it + 1, p.max_iter)
        tries = 0
    return it < p.max_iter, accept, lam, it, tries


FIELDS = ("R", "t", "Rn", "tn", "inc", "err", "A", "g", "good", "bad", "sum_w", "sum_unw",
          "lam", "iteration", "tries", "active")


def lane_state(state, b):
    """Lane b of a solver.LevelState as a dict of numpy values (FIELDS)."""
    info = state.sys.info
    vals = (state.R[b].reshape(9), state.t[b], state.Rn[b].reshape(9), state.tn[b],
            state.inc[b], state.sys.err[b], state.sys.A[b].reshape(36), state.sys.g[b],
            info.good[b], info.bad[b], info.sum_error_weighted[b],
            info.sum_error_unweighted[b], state.lam[b], state.iteration[b], state.tries[b],
            state.active[b])
    out = {}
    for name, v in zip(FIELDS, vals):
        v = v.numpy()
        out[name] = [F(x) for x in v] if v.ndim else (v.item() if v.dtype != np.float32 else F(v))
    return out


def step(s, row, p, pows, init, R0=None, t0=None):
    """The warp step on one lane's state ``s`` (a dict as ``lane_state``
    gives, unread at the start) from its K3 output row (46 float32, counts
    as int32 bits), the start pose R0 (9,), t0 (3,) at the start; returns
    the new state."""
    s = {k: (list(v) if isinstance(v, list) else v) for k, v in (s or {}).items()}
    counts = np.asarray(row, np.float32)[44:46].view(np.int32)
    good, bad = int(counts[0]), int(counts[1])
    row = [F(x) for x in row]
    take = False
    if init:
        s["R"], s["Rn"] = [F(x) for x in R0], [F(x) for x in R0]
        s["t"], s["tn"] = [F(x) for x in t0], [F(x) for x in t0]
        s["inc"] = [F(0.0)] * 6
        if p.gn:
            s.update(A=[F(0.0)] * 36, g=[F(0.0)] * 6, err=F(np.inf), good=0, bad=0,
                     sum_w=F(0.0), sum_unw=F(0.0))
        take = not p.gn
        lam, it, tries = F(p.lam0), 0, 0
        live = it < p.max_iter
    else:
        if not s["active"]:
            return s
        lam, it, tries = s["lam"], s["iteration"], s["tries"]
        n = F(max(good, 1))
        live, accept, lam, it, tries = rules(row[42] / n, s["err"], s["inc"], pows, p, lam, it,
                                             tries)
        if accept:
            s["R"], s["t"] = list(s["Rn"]), list(s["tn"])
        take = accept
    if take:
        n = F(max(good, 1))
        entries = [row[k] / n for k in range(43)]  # warp lanes k and k + 32
        s.update(A=entries[:36], g=entries[36:42], err=entries[42], sum_w=row[42],
                 sum_unw=row[43], good=good, bad=bad)
    if live:
        if not p.gn:
            tries += 1
        A, g = s["A"], s["g"]
        L = [[F(0.0)] * 6 for _ in range(6)]
        d = [F(0.0)] * 6
        for j in range(6):  # lane i < 6: row i; every lane: the pivot
            d[j] = ldlt_pivot(A[7 * j], lam, L[j], d, j)
            for i in range(j + 1, 6):
                L[i][j] = ldlt_entry(A[6 * i + j], L[i], L[j], d, j)
        x = ldlt_solve(L, d, g)
        a, b, c = exp_coeffs(x)
        W = hat(x)
        dR, V = zip(*(exp_entry(W, k, a, b, c) for k in range(9)))  # lanes k < 9
        R, t = s["R"], s["t"]
        s["Rn"] = [fma_chain3(dR[3 * i], R[j], dR[3 * i + 1], R[3 + j], dR[3 * i + 2], R[6 + j])
                   for i in range(3) for j in range(3)]
        s["tn"] = [dot3r(dR[3 * i:3 * i + 3], t) + dot3r(V[3 * i:3 * i + 3], x)
                   for i in range(3)]
        s["inc"] = list(x)
    s.update(lam=lam, iteration=it, tries=tries, active=bool(live))
    return s


def same(a, b) -> bool:
    """Two lane states bit for bit (NaN equal to NaN of the same bits)."""
    for name in FIELDS:
        x = np.asarray(a[name], np.float32 if name not in ("good", "bad", "iteration", "tries",
                                                           "active") else np.int64)
        y = np.asarray(b[name], x.dtype)
        if x.dtype == np.float32:
            if not np.array_equal(x.view(np.int32), y.view(np.int32)):
                return False
        elif not np.array_equal(x, y):
            return False
    return True
