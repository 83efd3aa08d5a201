"""Plain reference of what the benchmark's cells run: REVO's per-frame
pipeline written again as torch ops, imports nothing of the program.

Everything is computed in one float type ``dt`` (float64 for the reference,
bfloat16 for its control) on whatever device the tensors are on; masks,
indices and counts stay integer.  What the configuration states is kept
whatever ``dt`` is: the quad table "dt4bf" is stored in bfloat16, and the
capacity decimation of an edge cloud takes its slot as floor(pos * capacity
/ count) in float32.

- ``build``: the image pyramid (pyrDown 1-4-6-4-1 with REFLECT_101 borders,
  rounded; hole-aware 2x2 depth mean), Canny on every level (Sobel 3x3,
  squared L2 magnitude, OpenCV's sectors and NMS, 8-connected hysteresis),
  the BMVC17 edge fill-in of sparse levels, and each level's edge cloud
  (REVO imgpyramidrgbd.cpp:43-226).
- ``tables``: each level's exact Euclidean distance transform, its negated
  central differences (gx, gy, dt) and the 2x2 quad table of the form
  (imgpyramidrgbd.cpp:231-276).
- ``track``: the tracker's init check and coarse-to-fine Levenberg-Marquardt
  over the distance-transform residuals with a Huber weight
  (tracker.cpp:277-353, optimizer.cpp:74-311).
- ``vote``: the IROS17 histogram vote for a new keyframe
  (tracker.cpp:118-201).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TAN22 = 0.4142135623730950488
TG22 = float(torch.tensor(TAN22, dtype=torch.float32))
TG67 = float(torch.tensor(TAN22 + 2.0, dtype=torch.float32))
BIG = 1e9
PYR_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
TABLE_DTYPES = {"dt4bf": torch.bfloat16, "dt4": torch.float32}


def level_cams(cam: dict, n_levels: int):
    """Per-level pinholes: focal lengths and centre scaled by 2^-l, sizes
    truncated (camerapyr.h:140-144)."""
    out = []
    for lvl in range(n_levels):
        s = 1.0 / 2 ** lvl
        out.append(dict(fx=cam["fx"] * s, fy=cam["fy"] * s, cx=cam["cx"] * s, cy=cam["cy"] * s,
                        width=int(cam["width"] * s), height=int(cam["height"] * s)))
    return out


# -- pyramid --------------------------------------------------------------


def _pad101(x: torch.Tensor, r: int) -> torch.Tensor:
    """REFLECT_101 padding of (B, H, W) by r on every side."""
    return F.pad(x[:, None], (r, r, r, r), mode="reflect")[:, 0]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[-2:]
    x = _pad101(img, 2)
    row = sum(x[..., :, j:j + w] * PYR_TAPS[j] for j in range(5))
    out = sum(row[..., i:i + h, :] * PYR_TAPS[i] for i in range(5))
    return torch.round(out[..., ::2, ::2])


def depth_down(d: torch.Tensor) -> torch.Tensor:
    h2, w2 = d.shape[-2] // 2 * 2, d.shape[-1] // 2 * 2
    blocks = d[..., :h2, :w2].reshape(*d.shape[:-2], h2 // 2, 2, w2 // 2, 2)
    ok = blocks > 0
    total = torch.where(ok, blocks, torch.zeros_like(blocks)).sum(dim=(-3, -1))
    count = ok.sum(dim=(-3, -1))
    return torch.where(count > 0, total / count.clamp(min=1).to(d.dtype), torch.zeros_like(total))


# -- Canny ------------------------------------------------------------------


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], zero outside."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = x[
        ..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def canny(gray: torch.Tensor, t1: float, t2: float) -> torch.Tensor:
    """cv::Canny(gray, t1, t2, 3, L2gradient=true): (B, H, W) -> bool."""
    low, high = min(t1, t2), max(t1, t2)
    h, w = gray.shape[-2:]
    g = _pad101(gray, 1)

    def at(dy, dx):
        return g[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (at(-1, 1) + 2.0 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2.0 * at(0, -1) + at(1, -1))
    gy = (at(1, -1) + 2.0 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2.0 * at(-1, 0) + at(-1, 1))
    mag = gx * gx + gy * gy
    ax, ay = gx.abs(), gy.abs()
    keep = torch.where(
        ay < ax * TG22, (mag > _shift(mag, 0, -1)) & (mag >= _shift(mag, 0, 1)),
        torch.where(ay > ax * TG67, (mag > _shift(mag, -1, 0)) & (mag >= _shift(mag, 1, 0)),
                    torch.where((gx * gy) >= 0,
                                (mag > _shift(mag, -1, -1)) & (mag > _shift(mag, 1, 1)),
                                (mag > _shift(mag, -1, 1)) & (mag > _shift(mag, 1, -1)))))
    cand = keep & (mag > low * low)
    strong = cand & (mag > high * high)
    # Hysteresis: strong pixels grow through candidates, 8-connected, to
    # the fixpoint (checked every 8 steps, at most H + W steps).
    candf, reach = cand.float(), strong.float()
    steps, total = 0, reach.sum()
    while steps < h + w:
        for _ in range(8):
            reach = torch.maximum(reach, candf * F.max_pool2d(reach[:, None], 3, 1, 1)[:, 0])
        steps += 8
        new_total = reach.sum()
        if bool(new_total == total):
            break
        total = new_total
    return reach > 0.5


# -- the frame ---------------------------------------------------------------


def _patch_counts(edges: torch.Tensor, p: int):
    h, w = edges.shape[-2:]
    hp, wp = h // p, w // p
    e = edges[..., :hp * p, :wp * p].to(torch.int32)
    counts = e.reshape(-1, hp, p, wp, p).sum(dim=(-3, -1))
    occupancy = (counts > 0).sum(dim=(-2, -1)).double() / (hp * wp)
    return counts, occupancy


def _fill_in(edges, parent, counts, p: int, parent_p: int):
    """Child pixel (y, x) takes parent (2y+1, 2x+1) where the count bin of
    the parent pixel is under 5% of a patch (imgpyramidrgbd.cpp:130-140)."""
    h, w = edges.shape[-2:]
    ph, pw = parent.shape[-2:]
    dev = edges.device
    ys, xs = 2 * torch.arange(h, device=dev) + 1, 2 * torch.arange(w, device=dev) + 1
    par = parent[..., ys.clamp(max=ph - 1), :][..., xs.clamp(max=pw - 1)]
    par = par & (ys < ph)[:, None] & (xs < pw)[None, :]
    hc, wc = counts.shape[-2:]
    by = torch.clamp(ys // parent_p, max=hc - 1)
    bx = torch.clamp(xs // parent_p, max=wc - 1)
    sparse = (counts < p * p * 0.05)[..., by, :][..., bx]
    return edges | (sparse & par)


def _cloud(edges, depth, cam, dmin, dmax, capacity):
    """Edge pixels with depth strictly inside (dmin, dmax), in pixel order;
    above ``capacity`` pixel ``pos`` goes to slot floor(pos * capacity /
    count) (float32) and the last pixel of a slot wins."""
    b, h, w = edges.shape
    ok = (edges & torch.isfinite(depth) & (depth > dmin) & (depth < dmax)).reshape(b, -1)
    pos = torch.cumsum(ok.to(torch.int64), -1) - 1
    count = pos[:, -1] + 1
    scale = (torch.full((b,), float(capacity), dtype=torch.float32, device=edges.device)
             / count.clamp(min=capacity).to(torch.float32))
    slot = torch.where((count > capacity)[:, None],
                       torch.floor(pos.to(torch.float32) * scale[:, None]).to(torch.int64), pos)
    tgt = torch.where(ok & (slot < capacity), slot, capacity)
    tgt = tgt + (capacity + 1) * torch.arange(b, device=edges.device)[:, None]
    src = torch.arange(1, h * w + 1, device=edges.device).expand(b, -1)
    win = torch.zeros(b * (capacity + 1), dtype=torch.int64, device=edges.device)
    win = win.scatter_reduce(0, tgt.reshape(-1), src.reshape(-1), reduce="amax")
    win = win.reshape(b, capacity + 1)[:, :capacity]
    valid = win > 0
    idx = (win - 1).clamp(min=0)
    z = torch.gather(depth.reshape(b, -1), 1, idx)
    yy, xx = (idx // w).to(depth.dtype), (idx % w).to(depth.dtype)
    pts = torch.stack([z * (xx - cam["cx"]) / cam["fx"], z * (yy - cam["cy"]) / cam["fy"], z], -1)
    return torch.where(valid[..., None], pts, torch.zeros_like(pts)), valid


def build(gray_u8: torch.Tensor, depth_u16: torch.Tensor, cfg: dict, dt) -> list:
    """(B, H, W) uint8 gray and uint16 raw depth -> per level a dict of
    gray, depth (metres), edges_orig (Canny), edges (after fill-in),
    points (B, P, 3) and valid (B, P)."""
    pyr, n = cfg["pyramid"], cfg["pyramid"]["pyr_min_lvl"] + 1
    cams = level_cams(cfg["camera"], n)
    g = gray_u8.to(torch.int32).to(dt)
    d = depth_u16.to(torch.int32).to(dt) * (1.0 / cfg["dataset"]["depth_scale_factor"])
    levels, parent = [], None
    for lvl in range(n):
        if lvl:
            g, d = pyr_down(g), depth_down(d)
        edges_orig = canny(g, pyr["canny_threshold1"], pyr["canny_threshold2"])
        edges = edges_orig
        p = pyr["dist_patch_sizes"][lvl]
        counts, occupancy = _patch_counts(edges, p)
        if pyr["use_edge_hist"] and lvl > 0:
            filled = _fill_in(edges, parent, counts, p, pyr["dist_patch_sizes"][lvl - 1])
            sparse = occupancy < pyr["n_percentage"]
            edges = torch.where(sparse[:, None, None], filled, edges)
        pts, valid = _cloud(edges, d, cams[lvl], pyr["depth_min"], pyr["depth_max"],
                            pyr["edge_capacity"][lvl])
        levels.append(dict(gray=g, depth=d, edges_orig=edges_orig, edges=edges,
                           points=pts, valid=valid))
        parent = edges
    return levels


# -- keyframe tables -----------------------------------------------------------


def _shift_fill(x: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    out = torch.full_like(x, BIG)
    if abs(s) < n:
        if s > 0:
            out.narrow(dim, s, n - s).copy_(x.narrow(dim, 0, n - s))
        else:
            out.narrow(dim, 0, n + s).copy_(x.narrow(dim, -s, n + s))
    return out


def edt(edges: torch.Tensor, dt) -> torch.Tensor:
    """Exact Euclidean distance of every pixel to the nearest edge pixel:
    the vertical distance down each column by doubling, then each row's
    min over offsets o of g(x +- o)^2 + o^2, stopped once o^2 reaches the
    largest value left (cv::distanceTransform, DIST_MASK_PRECISE)."""
    h, w = edges.shape[-2:]
    init = torch.where(edges, 0.0, BIG).to(dt)

    def down(x, sign):
        s = 1
        while s < h:
            x = torch.minimum(x, _shift_fill(x, sign * s, -2) + s)
            s *= 2
        return x

    g = torch.minimum(down(init, 1), down(init, -1))
    g2 = torch.clamp(g * g, max=BIG)
    acc = g2
    o = 1
    while o < w:
        if o % 8 == 1 and float(acc.max()) <= o * o:
            break
        o2 = float(o * o)
        acc = torch.minimum(acc, torch.minimum(_shift_fill(g2, o, -1), _shift_fill(g2, -o, -1)) + o2)
        o += 1
    return torch.sqrt(acc)


def _clamped(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[..., ys, :][..., xs]


def tables(levels: list, form: str, dt) -> list:
    """Per level (structure (B, H, W, 3) = (gx, gy, dt), quad table (B, H*W,
    4) of the taps dt(y, x), dt(y, x+1), dt(y+1, x), dt(y+1, x+1), clamped
    at the borders, stored as ``form`` states)."""
    out = []
    for lv in levels:
        d = edt(lv["edges"], dt)
        gx = 0.5 * (_clamped(d, 0, -1) - _clamped(d, 0, 1))
        gy = 0.5 * (_clamped(d, -1, 0) - _clamped(d, 1, 0))
        struct = torch.stack([gx, gy, d], -1)
        taps = torch.stack([d, _clamped(d, 0, 1), _clamped(d, 1, 0), _clamped(d, 1, 1)], -1)
        store = TABLE_DTYPES[form]
        quad = taps.to(torch.float32 if dt == torch.float64 else dt).to(store)
        out.append((struct, quad.reshape(d.shape[0], -1, 4)))
    return out


# -- tracking -------------------------------------------------------------------


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(xi: torch.Tensor):
    """xi = (upsilon, omega) -> (R, V upsilon), Taylor terms near 0."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th * th * th))
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, (V @ v[..., None])[..., 0]


def _project(points, R, t, cam):
    p = (R[:, None] @ points[..., None])[..., 0] + t[:, None]
    z = torch.where(p[..., 2] == 0, torch.full_like(p[..., 2], 1e-12), p[..., 2])
    return p, p[..., 0] / z * cam["fx"] + cam["cx"], p[..., 1] / z * cam["fy"] + cam["cy"]


def _system(quad, points, valid, cam, R, t, edge_dist, huber, dt):
    """One evaluation: (err, A, g, good, bad) normalised by the good count."""
    p, u, v = _project(points, R, t, cam)
    h, w = cam["height"], cam["width"]
    inb = (u > 1.0) & (v > 1.0) & (u < w - 2.0) & (v < h - 2.0) & valid
    fu, fv = torch.floor(u), torch.floor(v)
    dx, dy = u - fu, v - fv
    ix = torch.nan_to_num(fu).clamp(0, w - 2).long()
    iy = torch.nan_to_num(fv).clamp(0, h - 2).long()
    q = torch.gather(quad, 1, (iy * w + ix)[..., None].expand(-1, -1, 4)).to(dt)
    i00, i01, i10, i11 = q.unbind(-1)
    dxdy = dx * dy
    r = dxdy * i11 + (dy - dxdy) * i10 + (dx - dxdy) * i01 + (1.0 - dx - dy + dxdy) * i00
    gx = -(dy * (i11 - i10) + (1.0 - dy) * (i01 - i00)) * cam["fx"]
    gy = -(dx * (i11 - i01) + (1.0 - dx) * (i10 - i00)) * cam["fy"]
    good = inb & (r <= edge_dist)
    n_good = good.sum(-1)
    n_bad = (valid & ~good).sum(-1)
    wt = torch.where(r <= huber, torch.ones_like(r), huber / torch.where(r == 0, 1.0, r))
    wt = torch.where(good, wt, torch.zeros_like(wt))
    x, y, z = p.unbind(-1)
    iz = 1.0 / torch.where(z == 0, torch.full_like(z, 1e-12), z)
    iz2 = iz * iz
    J = torch.stack([iz * gx, iz * gy, -x * iz2 * gx - y * iz2 * gy,
                     -x * y * iz2 * gx - (1.0 + y * y * iz2) * gy,
                     (1.0 + x * x * iz2) * gx + x * y * iz2 * gy,
                     -y * iz * gx + x * iz * gy], -1)
    J = torch.where(good[..., None], J, torch.zeros_like(J))
    r0 = torch.where(good, r, torch.zeros_like(r))
    n = n_good.clamp(min=1).to(dt)
    A = torch.einsum("bpi,bpj->bij", J * wt[..., None], J) / n[:, None, None]
    g = torch.einsum("bpi,bp->bi", J, wt * r0) / n[:, None]
    err = (wt * r0 * r0).sum(-1) / n
    return err, A, g, n_good, n_bad


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b for symmetric 6x6 A by LDL^T without pivoting, zero pivots
    clamped to 1e-30 (Eigen's ldlt on these well-posed systems)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = A[..., j, j] - sum((L[j][k] * L[j][k] * d[k] for k in range(j)), torch.zeros_like(b[..., 0]))
        d[j] = torch.where(s.abs() < 1e-30, torch.full_like(s, 1e-30), s)
        for i in range(j + 1, n):
            s = A[..., i, j] - sum((L[i][k] * L[j][k] * d[k] for k in range(j)), torch.zeros_like(b[..., 0]))
            L[i][j] = s / d[j]
    y = []
    for i in range(n):
        y.append(b[..., i] - sum((L[i][k] * y[k] for k in range(i)), torch.zeros_like(b[..., 0])))
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = y[i] / d[i] - sum((L[k][i] * x[k] for k in range(i + 1, n)), torch.zeros_like(y[i]))
    return torch.stack(x, -1)


def _candidate(A, g, lam, R, t):
    Ad = A + torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1) * lam[:, None])
    inc = solve6(Ad, g)
    inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
    dR, dtr = exp_se3(inc)
    return inc, dR @ R, (dR @ t[..., None])[..., 0] + dtr


def lm_level(quad, points, valid, cam, R, t, opt: dict, lvl: int, dt, max_inner: int = 32):
    """One level of LM over B lanes, each until its own exit
    (optimizer.cpp:235-311): accept on a lower error (lambda times the
    success factor, 0 once at or below 0.2), converge when err / last_err
    exceeds eps; on a reject lambda to 0.2 from 0 or times fail^tries, stop
    when |inc|^2 <= step_min; the iteration advances on accept, on a small
    step or after ``max_inner`` tries."""
    edge, huber = opt["edge_distance_lvl"][lvl], opt["huber_edge"]
    max_it, eps = opt["max_its_per_lvl"][lvl], opt["convergence_eps"][lvl]
    step_min, succ, fail = opt["step_size_min"][lvl], opt["lambda_success_fac"], opt["lambda_fail_fac"]
    b, dev = R.shape[0], R.device
    err, A, g, good, bad = _system(quad, points, valid, cam, R, t, edge, huber, dt)
    lam = torch.full((b,), opt["lambda_initial"][lvl], dtype=dt, device=dev)
    it = torch.zeros(b, dtype=torch.int64, device=dev)
    tries = torch.zeros(b, dtype=torch.int64, device=dev)
    active = it < max_it
    inc, Rn, tn = _candidate(A, g, lam, R, t)
    tries = tries + active.long()
    for _ in range(max_it * max_inner):
        if not bool(active.any()):
            break
        err_n, A_n, g_n, good_n, bad_n = _system(quad, points, valid, cam, Rn, tn, edge, huber, dt)
        ratio = err_n / err.clamp(min=1e-30)
        accept = err_n < err
        small = ~((inc * inc).sum(-1) > step_min)
        take = active & accept
        tk = take[:, None]
        R = torch.where(tk[..., None], Rn, R)
        t = torch.where(tk, tn, t)
        A = torch.where(tk[..., None], A_n, A)
        g = torch.where(tk, g_n, g)
        err = torch.where(take, err_n, err)
        good, bad = torch.where(take, good_n, good), torch.where(take, bad_n, bad)
        lam = torch.where(active, torch.where(
            accept, torch.where(lam <= 0.2, torch.zeros_like(lam), lam * succ),
            torch.where(lam == 0.0, torch.full_like(lam, 0.2), lam * fail ** tries.to(dt))), lam)
        stop = active & ((accept & (ratio > eps)) | (~accept & small))
        it = torch.where(stop, torch.full_like(it, max_it), it)
        nxt = active & (accept | small | (tries >= max_inner))
        it = torch.where(nxt, (it + 1).clamp(max=max_it), it)
        tries = torch.where(nxt, torch.zeros_like(tries), tries)
        active = active & (it < max_it)
        inc_c, Rn_c, tn_c = _candidate(A, g, lam, R, t)
        ak = active[:, None]
        inc = torch.where(ak, inc_c, inc)
        Rn = torch.where(ak[..., None], Rn_c, Rn)
        tn = torch.where(ak, tn_c, tn)
        tries = tries + active.long()
    return R, t, err, good, bad


def cost(quad, points, valid, cam: dict, R, t, opt: dict, lvl: int, dt) -> torch.Tensor:
    """The solver's objective at (R, t): the mean Huber-weighted squared
    residual over the good points of level ``lvl`` (B,)."""
    return _system(quad, points, valid, cam, R.to(dt), t.to(dt), opt["edge_distance_lvl"][lvl],
                   opt["huber_edge"], dt)[0]


def init_cost(struct, points, valid, cam, R, t, edge_dist):
    """The floor-sampled DT cost over in-bounds points within the edge
    distance, divided by their count (tracker.cpp:356-393)."""
    _, u, v = _project(points, R, t, cam)
    h, w = cam["height"], cam["width"]
    inb = (u >= 0) & (v >= 0) & (u < w) & (v < h) & valid
    ui = torch.nan_to_num(torch.floor(u)).clamp(0, w - 1).long()
    vi = torch.nan_to_num(torch.floor(v)).clamp(0, h - 1).long()
    res = torch.gather(struct[..., 2].reshape(struct.shape[0], -1), 1, vi * w + ui)
    ok = inb & (res <= edge_dist)
    return torch.where(ok, res, torch.zeros_like(res)).sum(-1) / ok.sum(-1).clamp(min=1).to(res.dtype)


def track(tabs: list, levels: list, R0, t0, cfg: dict, dt):
    """Coarse-to-fine tracking of B lanes: ``tabs`` the keyframes' tables,
    ``levels`` the frames' (``build``), from (R0 (B, 3, 3), t0 (B, 3)).
    Returns (R, t, err, good, bad)."""
    pyr, trk, opt = cfg["pyramid"], cfg["tracker"], cfg["optimizer"]
    cams = level_cams(cfg["camera"], pyr["pyr_min_lvl"] + 1)
    R, t = R0.to(dt), t0.to(dt)
    top = pyr["pyr_min_lvl"]
    if trk["check_init_values"]:
        struct, lv = tabs[top][0], levels[top]
        eye = torch.eye(3, dtype=dt, device=R.device).expand_as(R)
        zero = torch.zeros_like(t)
        edge = opt["edge_distance_lvl"][top]
        c_eye = init_cost(struct, lv["points"], lv["valid"], cams[top], eye, zero, edge)
        c_0 = init_cost(struct, lv["points"], lv["valid"], cams[top], R, t, edge)
        use_eye = c_eye < trk["init_check_margin"] * c_0
        R = torch.where(use_eye[:, None, None], eye, R)
        t = torch.where(use_eye[:, None], zero, t)
    for lvl in range(top, pyr["pyr_max_lvl"] - 1, -1):
        R, t, err, good, bad = lm_level(tabs[lvl][1], levels[lvl]["points"], levels[lvl]["valid"],
                                        cams[lvl], R, t, opt, lvl, dt)
    return R, t, err, good, bad


# -- keyframe selection ----------------------------------------------------------


def _inv(T: torch.Tensor) -> torch.Tensor:
    if T.dtype in (torch.float32, torch.float64):
        return torch.linalg.inv(T)
    return torch.linalg.inv(T.float()).to(T.dtype)


def vote(points, valid, poses, n, T_w_curr, depth, edges_orig, cfg: dict) -> torch.Tensor:
    """The histogram vote of B lanes at the histogram level: the K past
    frames' clouds (points (B, K, P, 3), valid (B, K, P), world poses (B, K,
    4, 4), ``n`` (B,) filled slots) projected under the current estimate
    mark a binary map each; their sum M over the current frame's original
    edges with valid depth gives counts c_j of pixels marked j times; a new
    keyframe is due when sum_j c_j w_j < c_0, once all K slots are filled."""
    trk, pyr = cfg["tracker"], cfg["pyramid"]
    cam = level_cams(cfg["camera"], pyr["pyr_min_lvl"] + 1)[trk["histogram_level"]]
    h, w = cam["height"], cam["width"]
    b, k = points.shape[:2]
    T = _inv(T_w_curr)[:, None] @ poses
    p = (T[:, :, None, :3, :3] @ points[..., None])[..., 0] + T[:, :, None, :3, 3]
    z = torch.where(p[..., 2] == 0, torch.full_like(p[..., 2], 1e-12), p[..., 2])
    u = p[..., 0] / z * cam["fx"] + cam["cx"]
    v = p[..., 1] / z * cam["fy"] + cam["cy"]
    slot = torch.arange(k, device=points.device)[None, :] < n[:, None]
    inb = (u >= 0) & (v >= 0) & (u < w) & (v < h) & valid & slot[..., None]
    lin = torch.where(inb, torch.floor(v).long().clamp(0, h - 1) * w
                      + torch.floor(u).long().clamp(0, w - 1), h * w)
    hit = torch.zeros((b, k, h * w + 1), dtype=torch.bool, device=points.device)
    hit = hit.scatter_(-1, lin, True)[..., :h * w]
    m = hit.sum(1)
    mask = (torch.isfinite(depth) & (depth > pyr["depth_min"]) & (depth < pyr["depth_max"])
            & edges_orig).reshape(b, -1)
    counts = torch.zeros((b, k + 1), dtype=torch.int64, device=points.device)
    counts = counts.scatter_add_(1, m, mask.long())
    weights = trk["hist_weights"]
    weighted = sum(counts[:, j].double() * weights[j] for j in range(1, k + 1))
    return (weighted < counts[:, 0].double()) & (n >= k)


def so3_angle(R: torch.Tensor) -> torch.Tensor:
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
