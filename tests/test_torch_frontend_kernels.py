"""The front end's and the keyframe's hand kernels (csrc/frontend.cu) on the
CPU: a numpy model of each kernel's algorithm, as its threads and blocks
run it, held bit for bit to the JAX function it stands for and to the
port's plain version, and the wrappers' routing.

- ``revo_edt_columns``: segments of rows, each thread's first and last
  edge, then a sweep down and one up a column;
- ``revo_keyframe_rows``: each pixel's search over offsets stopped once the
  offset's square reaches the best so far, by bands of rows with one halo
  row above and two below, the structure and the quad table of every quad
  form from the band's window alone;
- ``revo_edge_cloud``: tile counts, each block's sum of the tiles before
  it, the threads' scan, last-of-slot winners, and the zeros of the slots
  nobody wins (every slot written exactly once);
- ``revo_pyr_level``: pyrDown's taps in the plain version's order, rounded
  half to even, and the hole-aware 2x2 mean, from float32 and from uint8
  gray / uint16 depth.

Held to ``revo_tpu.ops.edt.keyframe_structure`` / ``quad_structure``,
``revo_tpu.ops.backproject.backproject_edges`` (jitted, as the JAX front end
runs it), ``revo_tpu.ops.filters.pyr_down`` and
``revo_tpu.ops.depth.subsample_depth_with_holes``, bit for bit.  The kernels
themselves run against their plain versions in ``chip_smoke.py`` phase 4.
"""
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.ops import backproject as jbp
from revo_tpu.ops import depth as jdepth
from revo_tpu.ops import edt as jedt
from revo_tpu.ops import filters as jfilt
from revo_tpu_torch import convert, kernels
from revo_tpu_torch.ops import backproject as tbp
from revo_tpu_torch.ops import edt as tedt
from revo_tpu_torch.ops import filters as tfilt

from test_ops import synthetic_depth, synthetic_gray

torch.set_num_threads(1)

SHAPES = [(120, 160), (61, 79), (37, 65)]
BIG = np.float32(1e9)
SRC = (kernels.SRC_DIR / "frontend.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


EDT_SEGMENTS = _const("EDT_SEGMENTS")
CLOUD_THREADS = _const("CLOUD_THREADS")
CLOUD_PER_THREAD = _const("CLOUD_PER_THREAD")
CLOUD_TILE = CLOUD_THREADS * CLOUD_PER_THREAD


def test_wrapper_constants_follow_the_source():
    assert tbp.CLOUD_TILE == CLOUD_TILE
    assert re.search(r"constexpr int CLOUD_TILE = CLOUD_THREADS \* CLOUD_PER_THREAD;", SRC)


def lanes_of(shape):
    """(B, H, W) edges: Canny of a synthetic image, no edge, all edges, one
    edge pixel in a corner (the longest searches), a sparse random set."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    canny = cv2.Canny(synthetic_gray(h, w, seed=3), 150, 100, apertureSize=3,
                      L2gradient=True) > 0
    corner = np.zeros(shape, bool)
    corner[h - 1, 0] = True
    return np.stack([canny, np.zeros(shape, bool), np.ones(shape, bool), corner,
                     rng.random(shape) < 0.01])


# -- the EDT pair ------------------------------------------------------------------


def model_columns(e: np.ndarray) -> np.ndarray:
    """revo_edt_columns on one (H, W) lane: EDT_SEGMENTS segments of rows a
    column; each finds its first and last edge, then sweeps down and up
    from the nearest edge rows of the other segments."""
    h, w = e.shape
    rows = -(-h // EDT_SEGMENTS)
    bounds = [(min(s * rows, h), min(s * rows + rows, h)) for s in range(EDT_SEGMENTS)]
    first = np.full((EDT_SEGMENTS, w), -1)
    last = np.full((EDT_SEGMENTS, w), -1)
    for s, (y0, y1) in enumerate(bounds):
        seg = e[y0:y1]
        if y1 > y0:
            has = seg.any(0)
            first[s] = np.where(has, y0 + seg.argmax(0), -1)
            last[s] = np.where(has, y1 - 1 - seg[::-1].argmax(0), -1)
    out = np.empty((h, w), np.float32)
    for s, (y0, y1) in enumerate(bounds):
        above = np.full(w, -1)
        for t in range(s - 1, -1, -1):
            above = np.where(above < 0, last[t], above)
        below = np.full(w, -1)
        for t in range(s + 1, EDT_SEGMENTS):
            below = np.where(below < 0, first[t], below)
        dn = {}
        for y in range(y0, y1):
            above = np.where(e[y], y, above)
            dn[y] = np.where(above < 0, -1, y - above)
        for y in range(y1 - 1, y0 - 1, -1):
            below = np.where(e[y], y, below)
            d = dn[y]
            d = np.where((below >= 0) & ((d < 0) | (below - y < d)), below - y, d)
            g = d.astype(np.float32)
            out[y] = np.where(d >= 0, np.minimum(g * g, BIG), BIG)
    return out


def model_row_dt(g2: np.ndarray) -> np.ndarray:
    """revo_keyframe_rows' search on (R, W) rows of g^2: every pixel from
    its own g^2 over offsets o = 1, 2, ... while o^2 < best and o reaches
    the row; a row of BIG only is skipped.  -> dt (R, W) float32."""
    r, w = g2.shape
    x = np.arange(w)
    best = g2.copy()
    reach = np.maximum(x, w - 1 - x)
    live = (g2 < BIG).any(1, keepdims=True)
    steps = 0
    for o in range(1, w):
        o2 = np.float32(o * o)
        active = live & (o <= reach) & (o2 < best)
        if not active.any():
            break
        steps += 1
        left = np.where(x - o >= 0, g2[:, np.clip(x - o, 0, w - 1)] + o2, np.inf)
        right = np.where(x + o < w, g2[:, np.clip(x + o, 0, w - 1)] + o2, np.inf)
        best = np.where(active, np.minimum(np.minimum(best, left), right), best)
    return np.sqrt(best).astype(np.float32)


def model_rows(g2: np.ndarray, band: int):
    """revo_keyframe_rows on one lane: blocks of ``band`` rows, each
    computing dt over its window (one row above, two below, clamped) and
    writing the structure and the four taps of each quad row of its band
    from the window alone.  -> (structure (H, W, 3), taps (H*W, 4, 3)),
    every entry written once."""
    h, w = g2.shape
    struct = np.full((h, w, 3), np.nan, np.float32)
    taps_out = np.full((h * w, 4, 3), np.nan, np.float32)
    half = np.float32(0.5)
    for y0 in range(0, h, band):
        y1 = min(y0 + band, h)
        lo, hi = max(y0 - 1, 0), min(y1 + 1, h - 1)
        dt = model_row_dt(g2[lo:hi + 1])

        def at(y, x):
            yc = np.clip(y, 0, h - 1)
            assert (yc >= lo).all() and (yc <= hi).all(), "read outside the window"
            return dt[yc - lo, np.clip(x, 0, w - 1)]

        ys, xs = np.mgrid[y0:y1, 0:w]
        taps = []
        for t in range(4):
            ty, tx = np.clip(ys + t // 2, 0, h - 1), np.clip(xs + t % 2, 0, w - 1)
            taps.append(np.stack([half * (at(ty, tx - 1) - at(ty, tx + 1)),
                                  half * (at(ty - 1, tx) - at(ty + 1, tx)), at(ty, tx)], -1))
        struct[y0:y1] = taps[0]
        rows = ys.ravel() * w + xs.ravel()
        assert np.isnan(taps_out[rows]).all(), "a quad row written twice"
        taps_out[rows] = np.stack(taps, -2).reshape(-1, 4, 3)
    assert not np.isnan(struct).any() and not np.isnan(taps_out).any()
    return struct, taps_out


def model_quad(taps: np.ndarray, form: str) -> np.ndarray:
    """The kernel's quad row of ``form`` from the four taps: dt only (C =
    4) or (gx, gy, dt) a tap (C = 12), in the table's dtype, as float32."""
    width, dtype = tedt.QUAD_FORMS[form]
    rows = taps[..., 2] if width == 4 else taps.reshape(-1, 12)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(dtype).float().numpy()


@pytest.fixture(scope="module")
def jax_tables():
    """JAX's structure and quad tables of every lane of every shape (one
    jitted program a shape, the lanes by vmap)."""
    forms = tuple(tedt.QUAD_FORMS)

    @jax.jit
    def tables(e):
        s = jax.vmap(jedt.keyframe_structure)(e)
        return s, tuple(jax.vmap(lambda x, f=f: jedt.quad_structure(x, f))(s) for f in forms)

    out = {}
    for shape in SHAPES:
        s, quads = tables(jnp.asarray(lanes_of(shape)))
        out[shape] = np.asarray(s), {f: np.asarray(q) for f, q in zip(forms, quads)}
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_column_sweeps(shape):
    """The segment sweeps equal the plain version's doubling relaxations
    (``edt_columns_ref``) on every lane."""
    e = lanes_of(shape)
    got = np.stack([model_columns(x) for x in e])
    np.testing.assert_array_equal(got, tedt.edt_columns_ref(torch.from_numpy(e)).numpy())
    assert (got[1] == BIG).all() and (got[2] == 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_row_search_and_tables(shape, jax_tables):
    """Columns, then the early-exit row search by bands with halo rows:
    the structure bit-equal to JAX's ``keyframe_structure`` and each of the
    seven quad forms' tables to JAX's ``quad_structure``, at several band
    heights (the bits do not depend on it); a lane with no edge is
    sqrt_rn(1e9) everywhere."""
    e = lanes_of(shape)
    s_j, quads_j = jax_tables[shape]
    for i in range(len(e)):
        struct, taps = model_rows(model_columns(e[i]), (1, 3, 4, 16, 5)[i])
        np.testing.assert_array_equal(struct, s_j[i])
        for form in tedt.QUAD_FORMS:
            want = convert.quad_from_numpy(quads_j[form][i], s_j[i].shape).astype(np.float32)
            np.testing.assert_array_equal(model_quad(taps, form), want, err_msg=f"{i} {form}")
        if i == 1:
            assert (struct[..., 2] == np.sqrt(BIG)).all()


@pytest.mark.parametrize("form", ["dt4bf", "flat"])
def test_tables_plain_versions(form):
    """The plain versions of the pair (``keyframe_rows_ref`` on
    ``edt_columns_ref``) and of the whole (``keyframe_tables_ref``, what a
    CPU keyframe runs) bit-equal to the model, batched over the lanes."""
    e = torch.from_numpy(lanes_of(SHAPES[2]))
    s_pair, q_pair = tedt.keyframe_rows_ref(tedt.edt_columns_ref(e), form)
    s_all, q_all = tedt.keyframe_tables_ref(e, form)
    g2 = tedt.edt_columns_ref(e).numpy()
    for i in range(e.shape[0]):
        struct, taps = model_rows(g2[i], 4)
        for s, q in ((s_pair, q_pair), (s_all, q_all)):
            np.testing.assert_array_equal(s[i].numpy(), struct)
            np.testing.assert_array_equal(q[i].float().numpy(), model_quad(taps, form))


# -- the edge cloud ----------------------------------------------------------------

CAM = dict(fx=150.0, fy=151.0, cx=80.3, cy=60.7, depth_min=0.1, depth_max=5.2)


def model_cloud(edges, depth, cap, fx, fy, cx, cy, depth_min, depth_max):
    """revo_edge_cloud on one lane, block by block and thread by thread:
    tile counts, the tiles before a block summed, each thread's
    CLOUD_PER_THREAD pixels scanned, then every valid pixel's slot, its win,
    and the zeros of the gaps and the tail; not over capacity, the slots
    from count on are zeroed in the blocks' grid-stride order.  Every slot
    is written exactly once.  -> (points, valid, count)."""
    f32 = np.float32
    h, w = edges.shape
    n = h * w
    ok = (edges & np.isfinite(depth) & (depth > f32(depth_min)) & (depth < f32(depth_max))).ravel()
    tiles = -(-n // CLOUD_TILE)
    padded = np.zeros(tiles * CLOUD_TILE, bool)
    padded[:n] = ok
    per_thread = padded.reshape(tiles, CLOUD_THREADS, CLOUD_PER_THREAD)
    tile_counts = per_thread.sum((1, 2))
    count = int(tile_counts.sum())
    over = count > cap
    scale = f32(cap) / f32(max(count, cap))
    inv_fx, inv_fy = f32(1.0 / f32(fx)), f32(1.0 / f32(fy))

    def slot(q):
        return int(np.floor(f32(q) * scale)) if over else q

    pts = np.full((cap, 3), np.nan, np.float32)
    val = np.full(cap, 7, np.uint8)
    writes = np.zeros(cap, int)

    def zero(j):
        pts[j] = 0.0
        val[j] = 0
        writes[j] += 1

    positions = []
    for t in range(tiles):
        before = int(tile_counts[:t].sum())
        if not over:
            for tid in range(CLOUD_THREADS):
                for j in range(count + t * CLOUD_THREADS + tid, cap, tiles * CLOUD_THREADS):
                    zero(j)
        c = per_thread[t].sum(1)
        base = before + np.cumsum(c) - c
        for tid in range(CLOUD_THREADS):
            pos = int(base[tid])
            for k in np.flatnonzero(per_thread[t, tid]):
                p = t * CLOUD_TILE + tid * CLOUD_PER_THREAD + int(k)
                positions.append((p, pos))
                s = slot(pos)
                win = True
                if over:
                    win = s < cap and (pos == count - 1 or slot(pos + 1) != s)
                    prev = slot(pos - 1) if pos > 0 else -1
                    for j in range(prev + 1, min(s, cap)):
                        zero(j)
                    if pos == count - 1:
                        for j in range(s + 1, cap):
                            zero(j)
                if win:
                    z = depth.ravel()[p]
                    xx, yy = f32(p % w), f32(p // w)
                    pts[s] = [(z * (xx - f32(cx))) * inv_fx, (z * (yy - f32(cy))) * inv_fy, z]
                    val[s] = 1
                    writes[s] += 1
                pos += 1
    # The scan's positions are the valid pixels' ranks in row-major order.
    assert [q for _, q in positions] == list(range(count))
    assert [p for p, _ in positions] == list(np.flatnonzero(ok))
    assert (writes == 1).all(), "a slot written twice or never"
    return pts, val.astype(bool), count


def cloud_lanes(shape):
    """(edges, depth) lanes: Canny edges over depth with holes, NaN, inf,
    negative and out-of-range values; all edges over that depth; no edge."""
    h, w = shape
    rng = np.random.default_rng(h + w)
    edges = lanes_of(shape)[[4, 2, 1, 0]]
    depth = synthetic_depth(h, w, seed=9, hole_frac=0.2)
    bad = rng.random(shape)
    depth[bad < 0.02] = np.nan
    depth[(bad >= 0.02) & (bad < 0.03)] = np.inf
    depth[(bad >= 0.03) & (bad < 0.04)] = -1.0
    depth[(bad >= 0.04) & (bad < 0.05)] = 9.0  # above depth_max
    depth[(bad >= 0.05) & (bad < 0.055)] = np.float32(0.1)  # on depth_min: out
    return edges, np.broadcast_to(depth, edges.shape).copy()


@pytest.mark.parametrize("shape", SHAPES)
def test_edge_cloud(shape):
    """The tile scan with last-of-slot winners bit-equal to jitted JAX
    ``backproject_edges`` (points, valid, count) and to the port's plain
    version, over and under capacity, on lanes with bad depths, all edges
    and none."""
    edges, depth = cloud_lanes(shape)
    n_valid = [int((e & np.isfinite(d) & (d > np.float32(0.1)) & (d < np.float32(5.2))).sum())
               for e, d in zip(edges, depth)]
    assert n_valid[1] > n_valid[0] > 0 and n_valid[2] == 0
    # lane 0 three times over, exactly full; lane 1 one over; all lanes under
    caps = (max(n_valid[0] // 3, 1), n_valid[0], n_valid[1] - 1, 2 * n_valid[1] + 7)

    @jax.jit
    def clouds(e, d):
        return tuple(jax.vmap(lambda e_, d_, c=c: jbp.backproject_edges(
            e_, d_, capacity=c, **CAM))(e, d) for c in caps)

    wants = clouds(jnp.asarray(edges), jnp.asarray(depth))
    for cap, want in zip(caps, wants):
        ref = tbp.backproject_edges_ref(torch.from_numpy(edges), torch.from_numpy(depth),
                                        capacity=cap, **CAM)
        for i in range(edges.shape[0]):
            pts, val, count = model_cloud(edges[i], depth[i], cap, **CAM)
            assert count == int(want.count[i]) == int(ref.count[i]) == n_valid[i]
            np.testing.assert_array_equal(val, np.asarray(want.valid[i]))
            np.testing.assert_array_equal(pts, np.asarray(want.points[i]), err_msg=f"{cap} {i}")
            np.testing.assert_array_equal(val, ref.valid[i].numpy())
            np.testing.assert_array_equal(pts, ref.points[i].numpy())


# -- the pyramid step -------------------------------------------------------------


def model_pyr(gray: np.ndarray, depth: np.ndarray):
    """revo_pyr_level on one lane (float32 gray and depth): a thread an
    output pixel, each source row's 5 taps summed along x, the rows along
    y, in order, rounded half to even; the depth of the 2x2 block as
    (tl + bl) + (tr + br) over its count of > 0 pixels."""
    f32 = np.float32
    h, w = gray.shape
    k = np.array([1, 4, 6, 4, 1], np.float32) / f32(16)

    def refl(j, n):
        return np.where(j < 0, -j, np.where(j > n - 1, 2 * (n - 1) - j, j))

    ii, jj = np.mgrid[0:(h + 1) // 2, 0:(w + 1) // 2]
    acc = None
    for t in range(5):
        ry = refl(2 * ii + t - 2, h)
        r = gray[ry, refl(2 * jj - 2, w)] * k[0]
        for u in range(1, 5):
            r = r + gray[ry, refl(2 * jj + u - 2, w)] * k[u]
        acc = r * k[t] if acc is None else acc + r * k[t]
    hd, wd = h // 2, w // 2
    tl, tr = depth[0:2 * hd:2, 0:2 * wd:2], depth[0:2 * hd:2, 1:2 * wd:2]
    bl, br = depth[1:2 * hd:2, 0:2 * wd:2], depth[1:2 * hd:2, 1:2 * wd:2]

    def v(x):
        return np.where(x > 0, x, f32(0))

    def c(x):
        return (x > 0).astype(np.float32)

    with np.errstate(invalid="ignore"):
        total = (v(tl) + v(bl)) + (v(tr) + v(br))
        cnt = (c(tl) + c(bl)) + (c(tr) + c(br))
        d = np.where(cnt > 0, total / np.maximum(cnt, f32(1)), f32(0))
    return np.rint(acc).astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_pyramid_step(shape):
    """The fused step bit-equal to JAX's ``pyr_down`` and
    ``subsample_depth_with_holes`` and to ``pyr_level_ref``, from float32
    and from uint8 gray with uint16 raw depth (scaled as the front end
    scales it), over depth with holes and NaN.  A third lane adds inf
    depth, held to the plain version alone: JAX's selector matmuls spread
    an inf along its row and column (0 * inf), the port keeps it in its
    block."""
    h, w = shape
    inv = 1.0 / 5000.0
    gray = np.stack([synthetic_gray(h, w, seed=s) for s in (1, 2, 5)])
    raw = np.stack([(synthetic_depth(h, w, seed=s, hole_frac=0.3) * 5000).astype(np.uint16)
                    for s in (3, 4, 6)])
    metres = raw.astype(np.float32) * np.float32(inv)
    metres[1:, ::7, ::5] = np.nan
    metres[2, 1::9, ::3] = np.inf
    for g_in, d_in, d_float in ((gray.astype(np.float32), metres, metres),
                                (gray, raw, raw.astype(np.float32) * np.float32(inv))):
        g_ref, d_ref = tfilt.pyr_level_ref(torch.from_numpy(g_in), torch.from_numpy(d_in), inv)
        for i in range(3):
            g_m, d_m = model_pyr(gray[i].astype(np.float32), d_float[i])
            np.testing.assert_array_equal(g_m, g_ref[i].numpy())
            np.testing.assert_array_equal(d_m, d_ref[i].numpy())
            if i < 2:
                np.testing.assert_array_equal(g_m, np.asarray(jfilt.pyr_down(jnp.asarray(
                    gray[i], jnp.float32))))
                np.testing.assert_array_equal(d_m, np.asarray(
                    jdepth.subsample_depth_with_holes(jnp.asarray(d_float[i]))))
        assert np.isinf(d_ref[2].numpy()).any() or d_in.dtype == np.uint16


# -- routing ----------------------------------------------------------------------


def _wrappers(device):
    e = torch.zeros((2, 9, 11), dtype=torch.bool, device=device)
    d = torch.ones((2, 9, 11), device=device)
    return {
        "edt_columns": (tedt.edt_columns, lambda: tedt.edt_columns(e)),
        "keyframe_rows": (tedt.keyframe_rows, lambda: tedt.keyframe_rows(d, "dt4bf")),
        "keyframe_tables": (tedt.keyframe_rows, lambda: tedt.keyframe_tables(e, "flat")),
        "backproject_edges": (tbp.backproject_edges,
                              lambda: tbp.backproject_edges(e, d, capacity=16, **CAM)),
        "pyr_level": (tfilt.pyr_level, lambda: tfilt.pyr_level(d, d)),
    }


@pytest.mark.parametrize("name", ["edt_columns", "keyframe_rows", "keyframe_tables",
                                  "backproject_edges", "pyr_level"])
def test_routing(name):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other device than the CPU or a CUDA card raises, as do tensors
    on two devices."""
    counter, fn = _wrappers("cpu")[name]
    before = counter.launches
    fn()
    assert counter.launches == before
    for other in (tedt.edt_columns, tedt.keyframe_rows, tbp.backproject_edges, tfilt.pyr_level):
        assert other.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        _wrappers("meta")[name][1]()
    e = torch.zeros((1, 9, 11), dtype=torch.bool)
    with pytest.raises(ValueError, match="different devices"):
        tbp.backproject_edges(e, torch.ones((1, 9, 11), device="meta"), capacity=4, **CAM)
    with pytest.raises(ValueError, match="different devices"):
        tfilt.pyr_level(torch.ones((1, 9, 11)), torch.ones((1, 9, 11), device="meta"))
