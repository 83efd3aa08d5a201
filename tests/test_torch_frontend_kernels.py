"""The front end's and the keyframe's hand kernels (csrc/frontend.cu) on the
CPU: a numpy model of each kernel's algorithm, as its threads and blocks
run it, held bit for bit to the JAX function it stands for and to the
port's plain version, and the wrappers' routing.

- ``revo_edt_columns_levels``: every level of a keyframe in one launch, a
  cluster of up to EDT_CHUNKS blocks a strip of EDT_STRIP columns (the
  bits do not depend on the cluster's size: every size is modelled), each
  block a chunk of rows as column words (bits), the chunks' first and last
  edges pushed between the cluster's blocks, the nearest edge above and
  below a pixel from its word, and chunks longer than a window walked in
  windows whose first edges go through the output;
- ``revo_keyframe_rows``: each pixel's search over offsets in groups of
  ROWS_GROUP, the stop rule tested once a group, reads past the row's end
  clamped to it (held bit for bit to the one-offset search), by bands of
  rows in clusters whose blocks share out the cluster's halo rows by
  columns and take their window rows from the band or the slices that hold
  them, the structure and the quad table of every quad form from the
  band's window alone;
- ``revo_edge_cloud``: a cluster of blocks a lane, each block's range of
  steps walked in rounds by its warps, the block's scan putting every
  valid pixel at its rank in a list, the counts traded between the
  cluster's blocks, each block's slot range a thread a slot (the last
  position of a slot wins it, a gap of the rounding is zeros), windows of
  the list where a block has more valid pixels than it holds, and the tail
  spread over the blocks (every slot written exactly once);
- ``revo_fill_levels``: every level of a lane in one launch, a cluster of
  blocks a lane, each block the counts of its bin rows in tiles of at most
  the block's count slots (whole bin rows, or 32-bin pieces of a row), the
  bit map of sparse patches a 32-bin word at a time, the blocks' counts of
  occupied patches summed by every block, then each block's rows of the
  level ORed with the parent's odd pixels under the map, every byte reached
  once through 16-byte chunks from the lane's first aligned byte (the head
  and tail as short chunks);
- ``revo_pyramid``: two steps a launch, a block a tile of the second step's
  level with its input window staged (REFLECT_101 halo), each staged row's
  taps along x once, the first step's tile with a 2-pixel halo reflected at
  that level's borders, then the second step from the tile; pyrDown's taps
  in the plain version's order, rounded half to even, and the hole-aware
  2x2 mean, from float32 and from uint8 gray / uint16 depth, the depth's
  levels halving on their own chain.

Held to ``revo_tpu.ops.edt._column_distances`` (squared and clamped),
``keyframe_structure`` / ``quad_structure``,
``revo_tpu.ops.backproject.backproject_edges`` (jitted, as the JAX front end
runs it), ``revo_tpu.ops.filters.pyr_down`` and
``revo_tpu.ops.depth.subsample_depth_with_holes`` (chained),
``revo_tpu.ops.edge_hist.patch_histogram`` / ``fill_in_edges`` with the
front end's ``where`` (level by level), bit for bit.  The kernels
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
from revo_tpu.ops import edge_hist as jhist
from revo_tpu.ops import edt as jedt
from revo_tpu.ops import filters as jfilt
from revo_tpu_torch import convert, kernels
from revo_tpu_torch.ops import backproject as tbp
from revo_tpu_torch.ops import edge_hist as thist
from revo_tpu_torch.ops import edt as tedt
from revo_tpu_torch.ops import filters as tfilt

from test_ops import synthetic_depth, synthetic_gray

torch.set_num_threads(1)

SHAPES = [(120, 160), (61, 79), (37, 65)]
BIG = np.float32(1e9)
SRC = (kernels.SRC_DIR / "frontend.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


EDT_STRIP = _const("EDT_STRIP")
EDT_CHUNKS = _const("EDT_CHUNKS")
EDT_THREADS = _const("EDT_THREADS")
EDT_WORDS = _const("EDT_WORDS")
EDT_WINDOW = 32 * EDT_WORDS
EDT_MAX_LEVELS = _const("EDT_MAX_LEVELS")
PYR_TH = int(re.search(r"constexpr int PYR_TH = (\d+), PYR_TW = (\d+);", SRC).group(1))
PYR_TW = int(re.search(r"constexpr int PYR_TH = (\d+), PYR_TW = (\d+);", SRC).group(2))
ROWS_GROUP = _const("ROWS_GROUP")
ROWS_CLUSTER = _const("ROWS_CLUSTER")
ROWS_BAND_MIN = _const("ROWS_BAND_MIN")
ROWS_BAND_MAX = _const("ROWS_BAND_MAX")
ROWS_PER_SM = _const("ROWS_PER_SM")
SMEM_OPTIN = 232448  # the H100's shared memory a block may opt in to (bytes)
CLOUD_THREADS = _const("CLOUD_THREADS")
CLOUD_STEP = _const("CLOUD_STEP")
CLOUD_STEPS = _const("CLOUD_STEPS")
CLOUD_LIST = _const("CLOUD_LIST")
CLOUD_CLUSTER_MAX = _const("CLOUD_CLUSTER_MAX")
CLOUD_WARPS = CLOUD_THREADS // 32
FILL_MAX_LEVELS = _const("FILL_MAX_LEVELS")
FILL_CLUSTER_MAX = _const("FILL_CLUSTER_MAX")
FILL_COUNTS_MAX = _const("FILL_COUNTS_MAX")
FILL_BITS_SHARED = _const("FILL_BITS_SHARED")


def test_wrapper_constants_follow_the_source():
    """The layouts the models follow: a warp's step is 4 pixels a lane (a
    4-byte load of edges, a 16-byte one of depth), a block's list fits the
    card's 227 KB of shared memory beside its scan, the search's minimum tree
    halves its group, clusters stay within the card's limits; and no wrapper
    keeps a layout constant of its own."""
    assert CLOUD_STEP == 32 * 4 and CLOUD_THREADS % 32 == 0 and CLOUD_THREADS <= 1024
    assert re.search(r"constexpr int CLOUD_WARPS = CLOUD_THREADS / 32;", SRC)
    assert CLOUD_LIST * 8 + 2 * 32 * 4 + 4 <= 232448
    assert ROWS_GROUP >= 2 and ROWS_GROUP & (ROWS_GROUP - 1) == 0
    assert ROWS_CLUSTER <= 8 and CLOUD_CLUSTER_MAX <= 16
    # The column pass: 4 warps of 16 columns a strip, 32 rows a word, a
    # portable cluster; its wrapper's level count is the kernel's.
    assert EDT_THREADS == 4 * EDT_STRIP and EDT_STRIP == 4 * 16 and EDT_CHUNKS <= 8
    assert re.search(r"constexpr int EDT_WINDOW = 32 \* EDT_WORDS;", SRC)
    assert tedt.EDT_MAX_LEVELS == EDT_MAX_LEVELS
    # The pyramid's staged window, its first step's tile and its shared
    # memory (static, under 48 KB).
    for name, want in (("PYR_ROWS0", "4 \\* PYR_TH \\+ 11"), ("PYR_COLS0", "4 \\* PYR_TW \\+ 16"),
                       ("PYR_ROWS1", "2 \\* PYR_TH \\+ 3"), ("PYR_COLS1", "2 \\* PYR_TW \\+ 3")):
        assert re.search(rf"{name} = {want}", SRC), name
    rows0, cols0 = 4 * PYR_TH + 11, 4 * PYR_TW + 16
    smem = 4 * (rows0 * cols0 + rows0 * (2 * PYR_TW + 3) + (2 * PYR_TH + 3) * (2 * PYR_TW + 3)
                + 4 * PYR_TH * PYR_TW)
    assert smem <= 48 * 1024 and (4 * PYR_TW) % 16 == 0
    assert re.search(r"slices = 3 \* \(size_t\)\(\(W \+ ROWS_CLUSTER - 1\) / ROWS_CLUSTER\);\n"
                     r"  return \(\(size_t\)\(band \+ 3\) \* W \+ std::max\(\(size_t\)band \* W, "
                     r"slices\)\) \* sizeof\(float\);", SRC)
    assert not hasattr(tbp, "CLOUD_TILE")
    # The fill-in: its wrapper's level count and shared-memory split are the
    # kernel's; two bit maps and the most count slots fit a block beside its
    # static counts; the slots are whole 32-bin words.
    assert (thist.FILL_MAX_LEVELS, thist.FILL_BITS_SHARED) == (FILL_MAX_LEVELS, FILL_BITS_SHARED)
    assert FILL_BITS_SHARED + 4 * FILL_COUNTS_MAX + 4 * (2 * FILL_CLUSTER_MAX + 1) <= SMEM_OPTIN
    assert FILL_COUNTS_MAX % 32 == 0 and FILL_CLUSTER_MAX <= 16


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


def _high_bit(x: np.ndarray) -> np.ndarray:
    """Index of the highest set bit of each nonzero uint32 (31 - __clz)."""
    return np.frexp(x.astype(np.float64))[1] - 1


def _low_bit(x: np.ndarray) -> np.ndarray:
    """Index of the lowest set bit of each nonzero uint32 (__ffs - 1)."""
    x = x.astype(np.int64)
    return _high_bit(x & -x)


def _words(e: np.ndarray) -> np.ndarray:
    """(R, C) bool rows -> (ceil(R / 32), C) uint32 column words, bit r % 32
    of word r // 32 row r (one ballot of 32 threads a column)."""
    r, c = e.shape
    pad = np.zeros((-(-r // 32) * 32, c), bool)
    pad[:r] = e
    bits = pad.reshape(-1, 32, c).astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None]
    return bits.sum(1).astype(np.uint32)


def _ends(words: np.ndarray, wy0: int):
    """Each column's first and last edge row of a window's words (-1: none)."""
    nz = words != 0
    k_first = np.where(nz.any(0), nz.argmax(0), -1)
    k_last = np.where(nz.any(0), len(words) - 1 - nz[::-1].argmax(0), -1)
    cols = np.arange(words.shape[1])
    first = np.where(k_first >= 0, wy0 + 32 * k_first
                     + _low_bit(np.where(k_first >= 0, words[k_first, cols], 1)), -1)
    last = np.where(k_last >= 0, wy0 + 32 * k_last
                    + _high_bit(np.where(k_last >= 0, words[k_last, cols], 1)), -1)
    return first, last


def model_columns(e: np.ndarray, window: int = EDT_WINDOW, stats=None,
                  cluster: int = EDT_CHUNKS) -> np.ndarray:
    """revo_edt_columns_levels on one (H, W) lane: strips of EDT_STRIP
    columns, each a cluster of ``cluster`` blocks (edt_cluster's 8, 4, 2 or
    1), block k the k-th chunk of ceil(H / cluster) rows in windows of
    ``window`` rows.  A block packs a
    window's rows into column words and finds each column's first and last
    edge; with more than one window it writes each window's first edge into
    the window's first output row (as int bits) and then their suffix (the
    first edge at or after each window).  It pushes its chunk's first edges
    to the blocks above it and its last to those below (DSMEM, before the
    cluster barrier); after the barrier each takes the nearest edge above
    and below its chunk from what it was given.  Then per window: a walk down
    the words (the last edge above each word, carried over the windows) and
    up (the first edge below each word, from the next window's slot or the
    chunk below), and each pixel's nearest edges from its own word: bits at
    or above its row by the highest set bit, at or below by the lowest (the
    kernel walks runs of 16 rows a thread, carrying the edge above; the same
    values).
    ``stats`` (a dict) counts the windows walked.  -> g^2 (H, W) float32,
    every pixel written once."""
    h, w = e.shape
    g2 = np.full((h, w), np.nan, np.float32)
    slots = g2.view(np.int32)
    rows = -(-h // cluster)
    for x0 in range(0, w, EDT_STRIP):
        cols = np.arange(x0, min(x0 + EDT_STRIP, w))
        chunks = []
        for rank in range(cluster):  # the loads and the chunk ends
            y0 = min(rank * rows, h)
            y1 = min(y0 + rows, h)
            nwin = -(-(y1 - y0) // window)
            first, last = np.full(len(cols), -1), np.full(len(cols), -1)
            for k in range(nwin):
                wy0 = y0 + k * window
                f, lst = _ends(_words(e[wy0:min(wy0 + window, y1), cols]), wy0)
                if nwin > 1:
                    slots[wy0, cols] = f
                first = np.where(first < 0, f, first)
                last = np.where(lst >= 0, lst, last)
            if nwin > 1:
                run = np.full(len(cols), -1)
                for k in range(nwin - 1, -1, -1):
                    run = np.where(slots[y0 + k * window, cols] >= 0, slots[y0 + k * window, cols],
                                   run)
                    slots[y0 + k * window, cols] = run
            chunks.append((y0, y1, nwin, first, last))
        for rank, (y0, y1, nwin, _, _) in enumerate(chunks):  # over DSMEM, then the walks
            near = np.full(len(cols), -1)
            for q in range(rank):
                near = np.where(chunks[q][4] >= 0, chunks[q][4], near)
            below = np.full(len(cols), -1)
            for q in range(cluster - 1, rank, -1):
                below = np.where(chunks[q][3] >= 0, chunks[q][3], below)
            for k in range(nwin):
                wy0 = y0 + k * window
                wy1 = min(wy0 + window, y1)
                if stats is not None:
                    stats["windows"] = stats.get("windows", 0) + 1
                words = _words(e[wy0:wy1, cols])
                prev = np.empty(words.shape, np.int64)
                for j in range(len(words)):
                    prev[j] = near
                    near = np.where(words[j] != 0, wy0 + 32 * j
                                    + _high_bit(np.where(words[j] != 0, words[j], 1)), near)
                run = below
                if k + 1 < nwin:
                    nxt = slots[wy0 + window, cols]
                    run = np.where(nxt >= 0, nxt, below)
                following = np.empty(words.shape, np.int64)
                for j in range(len(words) - 1, -1, -1):
                    following[j] = run
                    run = np.where(words[j] != 0, wy0 + 32 * j
                                   + _low_bit(np.where(words[j] != 0, words[j], 1)), run)
                ys = np.arange(wy0, wy1)[:, None]
                word = words[(ys - wy0) // 32, np.arange(len(cols))].astype(np.uint64)
                bit = ((ys - wy0) % 32).astype(np.uint64)
                up_bits = word & (np.uint64(0xFFFFFFFF) >> (np.uint64(31) - bit))
                down_bits = word & ((np.uint64(0xFFFFFFFF) << bit) & np.uint64(0xFFFFFFFF))
                base = wy0 + 32 * ((ys - wy0) // 32)
                above = np.where(up_bits != 0, base + _high_bit(np.where(up_bits != 0, up_bits, 1)),
                                 prev[(ys - wy0) // 32, np.arange(len(cols))])
                below_px = np.where(down_bits != 0,
                                    base + _low_bit(np.where(down_bits != 0, down_bits, 1)),
                                    following[(ys - wy0) // 32, np.arange(len(cols))])
                d = np.where(above < 0, -1, ys - above)
                d = np.where((below_px >= 0) & ((d < 0) | (below_px - ys < d)), below_px - ys, d)
                g = d.astype(np.float32)
                assert np.isnan(g2[wy0:wy1, cols]).all() or nwin > 1, "a pixel written twice"
                g2[wy0:wy1, cols] = np.where(d >= 0, np.minimum(g * g, BIG), BIG)
    assert not np.isnan(g2).any()
    return g2


def jax_columns(e: np.ndarray) -> np.ndarray:
    """JAX's ``_column_distances`` of (..., H, W) edges, squared and clamped
    to 1e9 as ``edt_columns_ref`` does."""
    g = np.asarray(jax.jit(jedt._column_distances)(jnp.asarray(e)))
    return np.minimum(g * g, BIG)


def model_row_dt_single(g2: np.ndarray) -> np.ndarray:
    """The one-offset search on (R, W) rows of g^2 (the first design): every
    pixel from its own g^2 over offsets o = 1, 2, ... while o^2 < best and
    o reaches the row; a row of BIG only is skipped.  -> dt (R, W)."""
    r, w = g2.shape
    x = np.arange(w)
    best = g2.copy()
    reach = np.maximum(x, w - 1 - x)
    live = (g2 < BIG).any(1, keepdims=True)
    for o in range(1, w):
        o2 = np.float32(o * o)
        active = live & (o <= reach) & (o2 < best)
        if not active.any():
            break
        left = np.where(x - o >= 0, g2[:, np.clip(x - o, 0, w - 1)] + o2, np.inf)
        right = np.where(x + o < w, g2[:, np.clip(x + o, 0, w - 1)] + o2, np.inf)
        best = np.where(active, np.minimum(np.minimum(best, left), right), best)
    return np.sqrt(best).astype(np.float32)


def model_row_dt(g2: np.ndarray, live: bool) -> np.ndarray:
    """revo_keyframe_rows' search (``row_search``) on (R, W) rows of g^2:
    offsets in groups of ROWS_GROUP from o = 1, the stop rule (o^2 >= best)
    tested at each group's first offset and the row's reach; an offset past
    the row's end reads the end pixel; each candidate min(l, r) + o^2; each
    group's candidates min-reduced by halves into the best.  ``live``: the
    block-wide flag that some g^2 is below BIG (else no search).  -> dt (R,
    W) float32."""
    r, w = g2.shape
    x = np.arange(w)
    best = g2.copy()
    reach = np.maximum(x, w - 1 - x)
    if not live:
        return np.sqrt(best).astype(np.float32)
    p = w + ROWS_GROUP  # the row padded with its end pixels: column x - u at p + x - u
    padded = np.pad(g2, ((0, 0), (p, p)), mode="edge")
    for o in range(1, w, ROWS_GROUP):
        active = (o <= reach) & ~(np.float32(o * o) >= best)
        if not active.any():
            break
        cand = []
        for k in range(ROWS_GROUP):
            u = o + k
            m = np.minimum(padded[:, p - u:p - u + w], padded[:, p + u:p + u + w])
            cand.append(m + np.float32(u * u))
        half = ROWS_GROUP // 2
        while half:
            cand = [np.minimum(cand[k], cand[k + half]) for k in range(half)]
            half //= 2
        best = np.where(active, np.minimum(best, cand[0]), best)
    return np.sqrt(best).astype(np.float32)


def rows_smem_floats(w: int, band: int) -> int:
    """A row-pass block's shared memory in floats (csrc/frontend.cu
    ``rows_smem_bytes``): the window (band + 3 rows) and the room of the
    band's g^2 rows, at least the three halo slices of a cluster of
    ROWS_CLUSTER blocks."""
    return (band + 3) * w + max(band * w, 3 * -(-w // ROWS_CLUSTER))


def rows_shape(lanes: int, h: int, w: int):
    """(band, cluster) of ``revo_keyframe_rows`` for ``lanes`` lanes of h x w
    on 132 SMs (csrc/frontend.cu ``rows_band``): ceil(H B / (ROWS_PER_SM
    132)) rows clamped to [ROWS_BAND_MIN, ROWS_BAND_MAX], fewer while the
    block's shared memory does not fit, (0, 0) where one row does not."""
    band = min(max(-(-(h * lanes) // (ROWS_PER_SM * 132)), ROWS_BAND_MIN), ROWS_BAND_MAX)
    while band > 1 and 4 * rows_smem_floats(w, band) > SMEM_OPTIN:
        band -= 1
    if 4 * rows_smem_floats(w, band) > SMEM_OPTIN:
        return 0, 0
    return band, min(ROWS_CLUSTER, -(-h // band))


def model_rows(g2: np.ndarray, band: int, cluster: int, searched=None):
    """revo_keyframe_rows on one lane: blocks of ``band`` rows in clusters of
    ``cluster`` blocks (the grid padded to whole clusters).  Each block
    loads its band's g^2 rows into their room and the cluster's halo rows
    (one above the cluster, two below, where they exist) into the window's
    outer rows (0; band + 1, band + 2); it searches its band into the
    window's rows 1 .. band, then its slice of columns (rank r: [r xs, (r +
    1) xs), xs = ceil(W / cluster)) of each halo row into the band's room.
    After the cluster barrier it copies its window's other rows (one above,
    two below, clamped) into the outer rows, from the block of its cluster
    that owns the band, or for a halo row from every block's slice; then it
    writes the structure and the four taps of each quad row of its band
    from its window alone.  ``searched`` (a list) gets each block's count of
    searched pixels.  -> (structure (H, W, 3), taps (H*W, 4, 3)), every
    entry written once."""
    h, w = g2.shape
    nb = -(-h // band)
    grid = -(-nb // cluster) * cluster
    xs = -(-w // cluster)
    room = rows_smem_floats(w, band) - (band + 3) * w  # the band's g^2, then the slices
    live = bool((g2 < BIG).any())  # the block-wide flag: the same in every block
    halo_dt = {}  # a halo row's dt, of which each block keeps its slice
    bands, slices = {}, {}
    for g in range(grid):  # the loads and the search
        rank, first = g % cluster, g - g % cluster
        y0 = min(g * band, h)
        y1 = min(y0 + band, h)
        cy0, cy1 = min(first * band, h), min((first + cluster) * band, h)
        halo = [r for r in (cy0 - 1, cy1, cy1 + 1) if cy0 < cy1 and 0 <= r < h]
        x0, x1 = min(rank * xs, w), min(rank * xs + xs, w)
        assert (y1 - y0) * w <= room, "the band's g^2 beyond its room"
        if halo:
            assert cluster == ROWS_CLUSTER, "halo rows in a cluster smaller than its room's"
            assert 3 * xs <= room, "the halo slices beyond the band's room"
        bands[g] = dict(zip(range(y0, y1), model_row_dt(g2[y0:y1], live)))
        for r in halo:
            if r not in halo_dt:
                halo_dt[r] = model_row_dt(g2[r:r + 1], live)[0]
        slices[g] = {r: halo_dt[r][x0:x1] for r in halo}
        if searched is not None:
            searched.append((y1 - y0) * w + len(halo) * (x1 - x0))
    struct = np.full((h, w, 3), np.nan, np.float32)
    taps_out = np.full((h * w, 4, 3), np.nan, np.float32)
    half = np.float32(0.5)
    for g in range(grid):  # the window over DSMEM, the tables
        first = g - g % cluster
        y0 = min(g * band, h)
        y1 = min(y0 + band, h)
        if y0 >= y1:
            continue
        cy0, cy1 = min(first * band, h), min((first + cluster) * band, h)
        lo, hi = max(y0 - 1, 0), min(y1 + 1, h - 1)
        window = np.full((band + 3, w), np.nan, np.float32)  # row y at y - y0 + 1
        for r in range(lo, hi + 1):
            if y0 <= r < y1:
                row = bands[g][r]
            elif cy0 <= r < cy1:
                owner = r // band
                assert first <= owner < first + cluster
                row = bands[owner][r]
            else:  # a halo row of the cluster: every block's slice, in column order
                row = np.concatenate([slices[first + k][r] for k in range(cluster)])
            assert 0 <= r - y0 + 1 < band + 3 and (y0 <= r < y1) == (1 <= r - y0 + 1 <= y1 - y0)
            window[r - y0 + 1] = row

        def at(y, x, y0=y0, window=window):
            yc = np.clip(y, 0, h - 1)
            got = window[yc - y0 + 1, np.clip(x, 0, w - 1)]
            assert not np.isnan(got).any(), "read outside the window"
            return got

        ys, xs_ = np.mgrid[y0:y1, 0:w]
        taps = []
        for t in range(4):
            ty, tx = np.clip(ys + t // 2, 0, h - 1), np.clip(xs_ + t % 2, 0, w - 1)
            taps.append(np.stack([half * (at(ty, tx - 1) - at(ty, tx + 1)),
                                  half * (at(ty - 1, tx) - at(ty + 1, tx)), at(ty, tx)], -1))
        assert np.isnan(struct[y0:y1]).all(), "a structure row written twice"
        struct[y0:y1] = taps[0]
        idx = ys.ravel() * w + xs_.ravel()
        assert np.isnan(taps_out[idx]).all(), "a quad row written twice"
        taps_out[idx] = np.stack(taps, -2).reshape(-1, 4, 3)
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
    """The column words, the chunk ends traded in the cluster and each
    pixel's own word give the plain version's doubling relaxations
    (``edt_columns_ref``) and JAX's ``_column_distances`` squared and
    clamped on every lane (no edge, all edges, a corner edge, sparse, Canny)
    bit for bit; W % 16 != 0 at 79 and 65 columns."""
    e = lanes_of(shape)
    got = np.stack([model_columns(x) for x in e])
    np.testing.assert_array_equal(got, tedt.edt_columns_ref(torch.from_numpy(e)).numpy())
    np.testing.assert_array_equal(got, jax_columns(e))
    assert (got[1] == BIG).all() and (got[2] == 0).all()
    for cluster in (1, 2, 4):  # the smaller clusters of larger B: the same bits
        np.testing.assert_array_equal(np.stack([model_columns(x, cluster=cluster) for x in e]), got)


@pytest.mark.parametrize("case", ["4320 rows", "windows", "small windows"])
def test_column_windows(case):
    """Tall lanes: 4320 rows (chunks of 540, one window each), a lane taller
    than EDT_CHUNKS windows (chunks of several windows, their first edges
    carried through the output), and the same walk with windows of 32 and
    64 rows on a short lane (many windows a chunk): columns with no edge,
    one edge in the first or the last row, and sparse ones, bit-equal to the
    plain version."""
    rng = np.random.default_rng(len(case))
    h, w = {"4320 rows": (4320, 19), "windows": (EDT_CHUNKS * EDT_WINDOW * 2 + 37, 5),
            "small windows": (700, 70)}[case]
    e = rng.random((h, w)) < 0.002
    e[:, 1] = False
    e[:, 2] = False
    e[0, 2] = True
    if w > 3:
        e[:, 3] = False
        e[h - 1, 3] = True
    want = tedt.edt_columns_ref(torch.from_numpy(e)[None])[0].numpy()
    for window in ((EDT_WINDOW,) if case != "small windows" else (32, 64)):
        stats = {}
        np.testing.assert_array_equal(model_columns(e, window, stats), want)
        chunk = -(-h // EDT_CHUNKS)
        assert stats["windows"] == EDT_CHUNKS * -(-w // EDT_STRIP) * -(-chunk // window)
        if case == "windows":  # a cluster of 2: chunks of 4 windows and more
            np.testing.assert_array_equal(model_columns(e, window, cluster=2), want)
        assert (window < chunk) == (case != "4320 rows")


def test_columns_levels_plain():
    """``edt_columns_levels`` on CPU tensors: every level's plain version, a
    list in the levels' order, lanes bit-equal to each alone; an empty list
    is refused."""
    levels = [torch.from_numpy(lanes_of(shape)[:3]) for shape in SHAPES]
    got = tedt.edt_columns_levels(levels)
    assert len(got) == len(levels) and tedt.edt_columns_levels.launches == 0
    for e, g2 in zip(levels, got):
        np.testing.assert_array_equal(g2.numpy(), np.stack([model_columns(x) for x in e.numpy()]))
    with pytest.raises(ValueError, match="at least one level"):
        tedt.edt_columns_levels([])


@pytest.mark.parametrize("shape", SHAPES)
def test_row_search_and_tables(shape, jax_tables):
    """Columns, then the grouped early-exit row search by bands in clusters
    with halo rows: the structure bit-equal to JAX's ``keyframe_structure``
    and each of the seven quad forms' tables to JAX's ``quad_structure``,
    at the bands and clusters the kernel takes for 1, 18, 40, 71 and 1000
    lanes of the shape (the bits do not depend on them); a lane with no
    edge is sqrt_rn(1e9) everywhere."""
    e = lanes_of(shape)
    s_j, quads_j = jax_tables[shape]
    for i in range(len(e)):
        band, cluster = rows_shape((1, 18, 40, 71, 1000)[i], *shape)
        struct, taps = model_rows(model_columns(e[i]), band, cluster)
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
    band, cluster = rows_shape(e.shape[0], *SHAPES[2])
    assert (band, cluster) == (2, ROWS_CLUSTER)
    for i in range(e.shape[0]):
        struct, taps = model_rows(g2[i], band, cluster)
        for s, q in ((s_pair, q_pair), (s_all, q_all)):
            np.testing.assert_array_equal(s[i].numpy(), struct)
            np.testing.assert_array_equal(q[i].float().numpy(), model_quad(taps, form))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_search_equals_single_offset(seed):
    """The grouped search (ROWS_GROUP offsets a stop test) bit-equal to the
    one-offset search on seeded rows: g^2 of sparse, dense, single and no
    edges, and arbitrary non-square floats with BIG holes."""
    rng = np.random.default_rng(seed)
    h, w = 40, 157
    rows = []
    for density in (0.002, 0.02, 0.3):
        rows.append(model_columns(rng.random((h, w)) < density))
    single = np.zeros((h, w), bool)
    single[rng.integers(h), rng.integers(w)] = True
    rows.append(model_columns(single))
    arb = (rng.random((h, w)) * 1e4).astype(np.float32)
    arb[rng.random((h, w)) < 0.7] = BIG
    rows.append(arb)
    for g2 in rows:
        got = model_row_dt(g2, bool((g2 < BIG).any()))
        np.testing.assert_array_equal(got, model_row_dt_single(g2))
    none = np.full((3, w), BIG, np.float32)
    np.testing.assert_array_equal(model_row_dt(none, False), model_row_dt_single(none))


def test_rows_cluster_halo(jax_tables):
    """The cluster's halo rows are shared out: at 120 rows in bands of 4
    (32 lanes), clusters of ROWS_CLUSTER, every block searches its band and a slice of
    columns of each halo row of its cluster (none above the image, none
    below it), so no block searches more than its band and three slices;
    every other window row comes over DSMEM from the band that owns it.  The
    tables stay JAX's."""
    e = lanes_of(SHAPES[0])[0]
    s_j, quads_j = jax_tables[SHAPES[0]]
    h, w = SHAPES[0]
    searched = []
    assert rows_shape(32, h, w) == (4, ROWS_CLUSTER)
    struct, taps = model_rows(model_columns(e), 4, ROWS_CLUSTER, searched)
    nb = h // 4
    xs = -(-w // ROWS_CLUSTER)
    want = []
    for g in range(-(-nb // ROWS_CLUSTER) * ROWS_CLUSTER):  # padding blocks search slices only
        first = g - g % ROWS_CLUSTER
        n_halo = (first > 0) + 2 * (first + ROWS_CLUSTER < nb)
        x0 = min((g % ROWS_CLUSTER) * xs, w)
        want.append(4 * w * (g < nb) + n_halo * (min(x0 + xs, w) - x0))
    assert searched == want
    assert max(searched) <= 4 * w + 3 * xs
    np.testing.assert_array_equal(struct, s_j[0])
    want_q = convert.quad_from_numpy(quads_j["flat"][0], s_j[0].shape).astype(np.float32)
    np.testing.assert_array_equal(model_quad(taps, "flat"), want_q)


@pytest.mark.parametrize("case", ["ragged", "short"])
def test_rows_ragged_and_short(case, jax_tables):
    """H not a multiple of the band (37 rows at 64 lanes: bands of 3 in
    clusters of 8, a last band of 1 row, a second cluster cut short with 3
    blocks past the image) and H smaller than a band (5 rows at 3200 lanes,
    a band of 16): the structure and the quad tables still JAX's, and the
    plain version's."""
    if case == "ragged":
        e = lanes_of(SHAPES[2])
        s_j, quads_j = jax_tables[SHAPES[2]]
        band, cluster = rows_shape(64, *SHAPES[2])
        assert (band, cluster) == (3, ROWS_CLUSTER)
    else:
        e = lanes_of(SHAPES[2])[:, :5]
        s_j = np.asarray(jax.vmap(jedt.keyframe_structure)(jnp.asarray(e)))
        quads_j = {"dt4bf": np.asarray(jax.vmap(lambda x: jedt.quad_structure(x, "dt4bf"))(
            jnp.asarray(s_j)))}
        band, cluster = rows_shape(3200, 5, SHAPES[2][1])
        assert (band, cluster) == (16, 1)
    s_ref, q_ref = tedt.keyframe_rows_ref(tedt.edt_columns_ref(torch.from_numpy(e)), "dt4bf")
    for i in range(len(e)):
        struct, taps = model_rows(model_columns(e[i]), band, cluster)
        np.testing.assert_array_equal(struct, s_j[i])
        np.testing.assert_array_equal(struct, s_ref[i].numpy())
        want = convert.quad_from_numpy(quads_j["dt4bf"][i], s_j[i].shape).astype(np.float32)
        np.testing.assert_array_equal(model_quad(taps, "dt4bf"), want)
        np.testing.assert_array_equal(model_quad(taps, "dt4bf"), q_ref[i].float().numpy())


@pytest.mark.parametrize("w", [7680, 11620])
def test_rows_wide(w):
    """Rows 7680 wide (bands of 2, as a 7680x4320 keyframe takes) and 11,620
    wide (a band of one row: rows up to 11,622 fit the card's shared
    memory, one more finds no band), in clusters with halo rows, the long
    searches of a lane whose edges lie in its first half: the model
    bit-equal to the plain version."""
    h = 18 if w == 7680 else 10
    rng = np.random.default_rng(w)
    e = rng.random((2, h, w)) < 0.002
    e[1, :, w // 2:] = False
    if w > 7680:
        e = e[:1]
    band, cluster = rows_shape(len(e), h, w)
    assert (band, cluster) == ((2, ROWS_CLUSTER) if w == 7680 else (1, ROWS_CLUSTER))
    assert rows_shape(1, 4320, 7680) == (2, ROWS_CLUSTER)
    assert rows_shape(1, 4, 11622)[0] == 1 and rows_shape(1, 4, 11623) == (0, 0)
    s_ref, q_ref = tedt.keyframe_rows_ref(tedt.edt_columns_ref(torch.from_numpy(e)), "flat")
    for i in range(len(e)):
        struct, taps = model_rows(model_columns(e[i]), band, cluster)
        np.testing.assert_array_equal(struct, s_ref[i].numpy())
        np.testing.assert_array_equal(model_quad(taps, "flat"), q_ref[i].float().numpy())


# -- the edge cloud ----------------------------------------------------------------

CAM = dict(fx=150.0, fy=151.0, cx=80.3, cy=60.7, depth_min=0.1, depth_max=5.2)


def _slot(q, over: bool, scale):
    """slot(pos) as the kernel's ``slot_of``: float32 product, floor."""
    q = np.asarray(q)
    return np.floor(q.astype(np.float32) * scale).astype(np.int64) if over else q


def _top(j, count: int, scale):
    """The kernel's ``top_of``: the highest pos < count with slot(pos) <= j
    (count > P), from a double estimate stepped up, then down."""
    q = np.minimum(count - 1, np.floor((j + 1.0) / float(scale))).astype(np.int64)
    while True:
        up = (q + 1 < count) & (_slot(np.minimum(q + 1, count - 1), True, scale) <= j)
        if not up.any():
            break
        q = q + up
    while True:
        down = (q > 0) & (_slot(q, True, scale) > j)
        if not down.any():
            break
        q = q - down
    return q


def model_cloud(edges, depth, cap, fx, fy, cx, cy, depth_min, depth_max, cluster=4,
                list_len=None, spans=None):
    """revo_edge_cloud on one lane, as a cluster of ``cluster`` blocks (list
    of ``list_len`` pairs a block, the kernel's min(CLOUD_LIST, its pixels)
    by default): block k walks its range of CLOUD_STEP-pixel steps in
    rounds of up to CLOUD_WARPS x CLOUD_STEPS steps, warp w a contiguous run
    of the round's steps and lane l pixels 4l .. 4l + 3 of each, the warp's
    step-by-step scans and the block's scan of the warps' totals giving each
    valid pixel its rank; the counts traded; then each window of list_len
    ranks (the walk repeated for every window after the first) writes the
    slots whose last position it holds, a thread a slot, and the blocks
    share the tail.  Every slot is written exactly once.  ``spans`` (a list)
    gets each block's (k, before, mine, first slot, last slot + 1) per
    window.  -> (points, valid, count)."""
    f32 = np.float32
    h, w = edges.shape
    n = h * w
    ok = (edges & np.isfinite(depth) & (depth > f32(depth_min)) & (depth < f32(depth_max))).ravel()
    z_all = depth.ravel()
    steps = -(-n // CLOUD_STEP)
    per = -(-steps // cluster)
    if list_len is None:
        list_len = min(CLOUD_LIST, per * CLOUD_STEP)

    def walk(s0, s1, r0):
        """-> (the block's valid pixels, {rank - r0: (index, depth)} of ranks
        r0 .. r0 + list_len - 1), by rounds, warps, steps and lanes as the
        kernel."""
        running, lst = 0, {}
        for rs in range(s0, s1, CLOUD_WARPS * CLOUD_STEPS):
            re_ = min(rs + CLOUD_WARPS * CLOUD_STEPS, s1)
            wper = -(-(re_ - rs) // CLOUD_WARPS)
            assert wper <= CLOUD_STEPS
            totals, pix = [], []
            for wp in range(CLOUD_WARPS):
                w0 = min(rs + wp * wper, re_)
                w1 = min(w0 + wper, re_)
                mine_px = [p for st in range(w0, w1) for ln in range(32) for i in range(4)
                           for p in [st * CLOUD_STEP + 4 * ln + i] if p < n and ok[p]]
                totals.append(len(mine_px))
                pix.append(mine_px)
            excl = np.cumsum(totals) - totals
            for wp in range(CLOUD_WARPS):
                for i, p in enumerate(pix[wp]):
                    r = running + int(excl[wp]) + i - r0
                    if 0 <= r < list_len:
                        assert r not in lst, "a list entry written twice"
                        lst[r] = (p, z_all[p])
            running += int(sum(totals))
        return running, lst

    ranges = [(min(k * per, steps), min(min(k * per, steps) + per, steps))
              for k in range(cluster)]
    walks = [walk(c0, c1, 0) for c0, c1 in ranges]
    mine = [m for m, _ in walks]  # each block's count, read by all over DSMEM
    count = int(sum(mine))
    over = count > cap
    scale = f32(cap) / f32(max(count, cap))
    inv_fx, inv_fy = f32(1.0 / f32(fx)), f32(1.0 / f32(fy))
    pts = np.full((cap, 3), np.nan, np.float32)
    val = np.full(cap, 7, np.uint8)
    writes = np.zeros(cap, int)
    for k, (c0, c1) in enumerate(ranges):
        before = int(sum(mine[:k]))
        for r0 in range(0, mine[k], list_len):
            lst = walks[k][1] if r0 == 0 else walk(c0, c1, r0)[1]
            q0, q1 = before + r0, before + min(r0 + list_len, mine[k])
            j0 = int(_slot(q0, over, scale))
            j1 = min(int(_slot(q1, over, scale)) - 1 if q1 < count
                     else int(_slot(count - 1, over, scale)), cap - 1)
            if spans is not None:
                spans.append((k, before, mine[k], j0, j1 + 1))
            j = np.arange(j0, j1 + 1)  # thread j - j0 (mod CLOUD_THREADS): one slot each
            if not len(j):
                continue
            q = _top(j, count, scale) if over else j
            win = _slot(q, over, scale) == j
            assert ((q[win] >= q0) & (q[win] < q1)).all(), "a winner outside the window"
            for jj, qq, wn in zip(j, q, win):
                writes[jj] += 1
                if not wn:
                    pts[jj], val[jj] = 0.0, 0
                    continue
                p, z = lst[int(qq) - q0]
                xx, yy = f32(p % w), f32(p // w)
                pts[jj] = [(z * (xx - f32(cx))) * inv_fx, (z * (yy - f32(cy))) * inv_fy, z]
                val[jj] = 1
    t0 = 0 if count == 0 else min(int(_slot(count - 1, over, scale)) + 1, cap)
    tper = -(-(cap - t0) // cluster)
    for k in range(cluster):  # the tail, shared
        for jj in range(t0 + k * tper, min(t0 + (k + 1) * tper, cap)):
            pts[jj], val[jj] = 0.0, 0
            writes[jj] += 1
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
    """The cluster scan with last-of-slot winners bit-equal to jitted JAX
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


def _cloud_against_jax(edges, depth, caps, cluster, list_len=None, spans=None):
    """model_cloud on each lane of (B, H, W) edges / depth at each capacity,
    bit-equal to jitted JAX ``backproject_edges`` and to the plain version."""
    @jax.jit
    def clouds(e, d):
        return tuple(jax.vmap(lambda e_, d_, c=c: jbp.backproject_edges(
            e_, d_, capacity=c, **CAM))(e, d) for c in caps)

    wants = clouds(jnp.asarray(edges), jnp.asarray(depth))
    counts = []
    for cap, want in zip(caps, wants):
        ref = tbp.backproject_edges_ref(torch.from_numpy(edges), torch.from_numpy(depth),
                                        capacity=cap, **CAM)
        for i in range(edges.shape[0]):
            pts, val, count = model_cloud(edges[i], depth[i], cap, **CAM, cluster=cluster,
                                          list_len=list_len, spans=spans)
            assert count == int(want.count[i]) == int(ref.count[i])
            np.testing.assert_array_equal(val, np.asarray(want.valid[i]))
            np.testing.assert_array_equal(pts, np.asarray(want.points[i]), err_msg=f"{cap} {i}")
            np.testing.assert_array_equal(val, ref.valid[i].numpy())
            np.testing.assert_array_equal(pts, ref.points[i].numpy())
            counts.append(count)
    return counts


def test_cloud_one_block_and_corner():
    """A lane whose valid pixels all lie in one block's range (the rows of
    the first block of 4), a lane with one edge pixel in a corner, and a
    lane whose valid pixels lie in the last block alone: over and under
    capacity and exactly full, the other blocks writing only their share of
    the tail."""
    h, w = SHAPES[0]
    rng = np.random.default_rng(5)
    block_px = -(-(-(-h * w // CLOUD_STEP)) // 4) * CLOUD_STEP  # a block's pixels of 4
    top, bottom = block_px // w, -(-3 * block_px // w)  # rows of block 0; from block 3 on
    e = np.zeros((3, h, w), bool)
    e[0, :top] = rng.random((top, w)) < 0.3
    e[1, h - 1, w - 1] = True
    e[2, bottom:] = rng.random((h - bottom, w)) < 0.3
    depth = np.broadcast_to(synthetic_depth(h, w, seed=2, hole_frac=0.0) * 0 + 1.5, e.shape).copy()
    n0 = int(e[0].sum())
    spans = []
    counts = _cloud_against_jax(e, depth, (n0 // 2, n0, 1, 4 * n0), 4, spans=spans)
    assert counts[:3] == [n0, 1, int(e[2].sum())]
    assert {k for k, before, mine, j0, j1 in spans if mine} <= {0, 3}


def _boundary_case(kind: str):
    """(cap, count, q) with count > cap where slot(q + 1) - slot(q) is 1 (a
    new slot starts at q + 1) or 0 (q and q + 1 share a slot), q + 1 and
    count - q - 1 each at most 9600 (half of a 160x120 lane)."""
    for cap in range(7001, 9500, 13):
        count = cap + 1 + cap % 97
        scale = np.float32(cap) / np.float32(count)
        d = np.diff(_slot(np.arange(count), True, scale))
        qs = np.flatnonzero(d == (1 if kind == "step" else 0))
        qs = qs[(qs + 1 <= 9600) & (count - qs - 1 <= 9600)]
        if len(qs):
            return cap, count, int(qs[len(qs) // 2])
    raise AssertionError(f"no {kind} boundary found")


def test_cloud_rounding_leaves_no_gap():
    """slot(pos + 1) - slot(pos) is 0 or 1 for every pos when count > P and
    count < 2^24: f32(pos) is exact and the product, rounded to nearest,
    cannot pass two integers for a step below 1.  So the gap rule of the
    kernel (a slot no position maps to holds zeros) is a guard: checked over
    every capacity with count = P + 1, P + 2, P + 3 up to 19,200 (a 160x120
    lane), and 4,000 seeded pairs up to 307,200 (640x480)."""
    rng = np.random.default_rng(21)
    pairs = [(cap, cap + k) for cap in range(1, 19200) for k in (1, 2, 3)]
    pairs += [(int(c), int(c) + int(k)) for c, k in zip(rng.integers(1, 300000, 4000),
                                                        rng.integers(1, 300000, 4000))]
    for cap, count in pairs:
        if count > 307200:
            continue
        scale = np.float32(cap) / np.float32(count)
        sl = _slot(np.arange(count), True, scale)
        d = np.diff(sl)
        assert d.min() >= 0 and d.max() <= 1, (cap, count)
        assert sl[-1] < cap, (cap, count)


@pytest.mark.parametrize("kind", ["step", "shared"])
def test_cloud_straddles_blocks(kind):
    """count > P with the boundary between two blocks right after pos q (q
    the last valid pixel of block 0 of 2) where a new slot starts at q + 1
    ("step") or where q and q + 1 share a slot ("shared"), and the same
    boundary between two windows of one block's list (list_len = q + 1):
    the shared slot goes to the block (window) of its last position, every
    slot once; bit-equal to JAX."""
    cap, count, q = _boundary_case(kind)
    h, w = SHAPES[0]
    half = h * w // 2  # block 0 of 2 takes the first 9600 pixels
    rng = np.random.default_rng(cap)
    e = np.zeros(h * w, bool)
    e[np.sort(rng.choice(half, q + 1, replace=False))] = True
    e[half + np.sort(rng.choice(h * w - half, count - q - 1, replace=False))] = True
    e = e.reshape(1, h, w)
    depth = np.full(e.shape, 2.0, np.float32)
    spans = []
    _cloud_against_jax(e, depth, (cap,), 2, spans=spans)
    (_, _, m0, j00, j01), (_, b1, _, j10, j11) = spans
    scale = np.float32(cap) / np.float32(count)
    s_q, s_q1 = int(_slot(q, True, scale)), int(_slot(q + 1, True, scale))
    assert (m0, b1, j00, j01, j10, j11) == (q + 1, q + 1, 0, s_q1, s_q1,
                                            int(_slot(count - 1, True, scale)) + 1)
    assert s_q1 - s_q == (1 if kind == "step" else 0)
    spans = []
    _cloud_against_jax(e, depth, (cap,), 1, list_len=q + 1, spans=spans)
    assert [(j0, j1) for _, _, _, j0, j1 in spans] == [(0, s_q1), (s_q1, j11)]


def test_cloud_full_and_empty():
    """count == P (every slot a point, no tail), count == 0 (every slot a
    zero, the tail spread over all blocks), and a lane of mostly edges whose
    blocks hold more valid pixels than a small list (three windows each),
    at the smallest and the largest cluster."""
    h, w = SHAPES[0]
    rng = np.random.default_rng(11)
    e = np.stack([rng.random((h, w)) < 0.05, np.zeros((h, w), bool), rng.random((h, w)) < 0.9])
    depth = np.full(e.shape, 3.0, np.float32)
    n0 = int(e[0].sum())
    for cluster in (1, CLOUD_CLUSTER_MAX):
        counts = _cloud_against_jax(e, depth, (n0,), cluster, list_len=int(e[2].sum()) // 7)
        assert counts == [n0, 0, int(e[2].sum())]


# -- the pyramid step -------------------------------------------------------------


_K5 = [np.float32(k) / np.float32(16) for k in (1, 4, 6, 4, 1)]


def _refl(j, n):
    """REFLECT_101 of index j in [0, n), one reflection."""
    return np.where(j < 0, -j, np.where(j > n - 1, 2 * (n - 1) - j, j))


def _taps(values):
    """pyrDown's 5 taps summed as the plain version sums them: the product
    with the first tap, then each further product added in order."""
    acc = values[0] * _K5[0]
    for u in range(1, 5):
        acc = acc + values[u] * _K5[u]
    return acc


def _hole_mean(tl, tr, bl, br):
    """(tl + bl) + (tr + br) of the > 0 values over their count, 0 for none."""
    f32 = np.float32

    def v(x):
        return np.where(x > 0, x, f32(0))

    def c(x):
        return (x > 0).astype(f32)

    with np.errstate(invalid="ignore"):
        total = (v(tl) + v(bl)) + (v(tr) + v(br))
        cnt = (c(tl) + c(bl)) + (c(tr) + c(br))
        return np.where(cnt > 0, total / np.maximum(cnt, f32(1)), f32(0)).astype(f32)


def _write_once(out, idx, val):
    assert np.isnan(out[idx]).all(), "a pixel written twice"
    out[idx] = val


def model_pyr(gray: np.ndarray, depth: np.ndarray, steps: int = 2, stats=None):
    """revo_pyramid on one lane: (H, W) float32 gray, (HD, WD) float32 depth
    (HD <= H, WD <= W: the depth's chain halves rounding down) -> the next
    ``steps`` levels [(gray, depth), ...].  A block a PYR_TH x PYR_TW tile
    (Y, X) of the second step's gray level (of the level it would be, one
    step); it stages input rows [4Y - 6, 4Y + 4 PYR_TH + 5) and columns [4X -
    8, 4X + 4 PYR_TW + 8) (zeros outside the image), takes the first step's
    depth of its 2x2 cells [2Y, 2Y + 2 PYR_TH) x [2X, 2X + 2 PYR_TW) from the
    input, sums the taps along x of every staged row for the first step's
    columns [2X - 2, 2X + 2 PYR_TW] it needs (at their reflected column, the
    taps at the input's reflected columns), then along y for the first
    step's rows, each at its reflected row, into a tile with that 2-pixel
    halo, of which it writes its own rows and columns; the second step reads
    the tile (gray) and the cells (depth).  Every read lies in what the block
    staged or computed, every output is written once.  ``stats`` gets the
    blocks."""
    f32 = np.float32
    h, w = gray.shape
    hd, wd = depth.shape
    h1, w1, hd1, wd1 = (h + 1) // 2, (w + 1) // 2, hd // 2, wd // 2
    h2, w2, hd2, wd2 = (h1 + 1) // 2, (w1 + 1) // 2, hd1 // 2, wd1 // 2
    two = steps == 2
    rows0, cols0, rows1, cols1 = 4 * PYR_TH + 11, 4 * PYR_TW + 16, 2 * PYR_TH + 3, 2 * PYR_TW + 3
    g1, d1 = np.full((h1, w1), np.nan, f32), np.full((hd1, wd1), np.nan, f32)
    g2, d2 = np.full((h2, w2), np.nan, f32), np.full((hd2, wd2), np.nan, f32)
    for Y in range(0, h2, PYR_TH):
        for X in range(0, w2, PYR_TW):
            if stats is not None:
                stats["blocks"] = stats.get("blocks", 0) + 1
            ys0, xs0 = 4 * Y - 6, 4 * X - 8
            yy, xx = ys0 + np.arange(rows0), xs0 + np.arange(cols0)
            in_y, in_x = (yy >= 0) & (yy < h), (xx >= 0) & (xx < w)
            g0s = np.zeros((rows0, cols0), f32)
            g0s[np.ix_(in_y, in_x)] = gray[np.ix_(yy[in_y], xx[in_x])]
            # the depth's cells
            r, c = 2 * Y + np.arange(2 * PYR_TH), 2 * X + np.arange(2 * PYR_TW)
            rr, cc = r[r < hd1], c[c < wd1]
            d1s = np.full((2 * PYR_TH, 2 * PYR_TW), np.nan, f32)
            if len(rr) and len(cc):
                q = [depth[np.ix_(2 * rr + dy, 2 * cc + dx)] for dy in (0, 1) for dx in (0, 1)]
                m = _hole_mean(*q)
                _write_once(d1, np.ix_(rr, cc), m)
                d1s[np.ix_(rr - 2 * Y, cc - 2 * X)] = m
            own_r1, own_c1 = min(2 * Y + 2 * PYR_TH, h1), min(2 * X + 2 * PYR_TW, w1)
            v_lo, u_lo = (2 * Y - 2, 2 * X - 2) if two else (2 * Y, 2 * X)
            v_hi = max(2 * min(Y + PYR_TH, h2), own_r1 - 1) if two else own_r1 - 1
            u_hi = max(2 * min(X + PYR_TW, w2), own_c1 - 1) if two else own_c1 - 1
            # the first step along x: every staged row, the columns needed
            u = 2 * X - 2 + np.arange(cols1)
            u_ok = (u >= u_lo) & (u <= u_hi)
            c1 = _refl(u[u_ok], w1)
            cidx = [_refl(2 * c1 + t - 2, w) - xs0 for t in range(5)]
            assert all(((i >= 0) & (i < cols0) & in_x[np.clip(i, 0, cols0 - 1)]).all()
                       for i in cidx), "a tap outside the staged columns"
            hs = np.full((rows0, cols1), np.nan, f32)
            hs[np.ix_(in_y, u_ok)] = _taps([g0s[np.ix_(in_y, i)] for i in cidx])
            # along y, into the tile with its halo
            v = 2 * Y - 2 + np.arange(rows1)
            v_ok = (v >= v_lo) & (v <= v_hi)
            r1 = _refl(v[v_ok], h1)
            ridx = [_refl(2 * r1 + t - 2, h) - ys0 for t in range(5)]
            taps = [hs[np.ix_(i, np.flatnonzero(u_ok))] for i in ridx]
            assert not any(np.isnan(t).any() for t in taps), "a tap outside the staged rows"
            val = np.rint(_taps(taps)).astype(f32)
            g1s = np.full((rows1, cols1), np.nan, f32)
            g1s[np.ix_(v_ok, u_ok)] = val
            own_v = (v >= 2 * Y) & (v < own_r1)
            own_u = (u >= 2 * X) & (u < own_c1)
            _write_once(g1, np.ix_(v[own_v], u[own_u]), g1s[np.ix_(own_v, own_u)])
            if not two:
                continue
            gi, gj = Y + np.arange(PYR_TH), X + np.arange(PYR_TW)
            gi, gj = gi[gi < h2], gj[gj < w2]
            rv, cu = 2 * (gi - Y), 2 * (gj - X)
            rows_sum = [_taps([g1s[np.ix_(rv + t, cu + k)] for k in range(5)]) for t in range(5)]
            assert not any(np.isnan(x).any() for x in rows_sum), "a tap outside the tile"
            _write_once(g2, np.ix_(gi, gj), np.rint(_taps(rows_sum)).astype(f32))
            gi, gj = gi[gi < hd2], gj[gj < wd2]
            if len(gi) and len(gj):
                r, c = 2 * (gi - Y), 2 * (gj - X)
                q = [d1s[np.ix_(r + dy, c + dx)] for dy in (0, 1) for dx in (0, 1)]
                assert not any(np.isnan(x).any() for x in q), "a cell outside the tile"
                _write_once(d2, np.ix_(gi, gj), _hole_mean(*q))
    outs = [(g1, d1), (g2, d2)][:steps]
    assert not any(np.isnan(x).any() for lv in outs for x in lv), "a pixel never written"
    return outs


def model_pyramid(gray: np.ndarray, depth: np.ndarray, n_levels: int, stats=None):
    """``pyramid`` on one lane of float32 level 0: launches of two steps
    (one for the last of an odd count) from the last level made."""
    levels = [(gray, depth)]
    while len(levels) < n_levels:
        levels += model_pyr(*levels[-1], min(2, n_levels - len(levels)), stats)
    return levels


def pyr_lanes(shape):
    """(gray float32, raw uint16 depth, depth in metres) of 3 lanes: synthetic
    gray and depth with holes; lanes 1-2 with NaN depth, lane 2 with inf."""
    h, w = shape
    inv = np.float32(1.0 / 5000.0)
    gray = np.stack([synthetic_gray(h, w, seed=s) for s in (1, 2, 5)]).astype(np.float32)
    raw = np.stack([(synthetic_depth(h, w, seed=s, hole_frac=0.3) * 5000).astype(np.uint16)
                    for s in (3, 4, 6)])
    metres = raw.astype(np.float32) * inv
    metres[1:, ::7, ::5] = np.nan
    metres[2, 1::9, ::3] = np.inf
    return gray, raw, metres


@pytest.mark.parametrize("shape", SHAPES)
def test_pyramid_step(shape):
    """The tiled two-step launch bit-equal to JAX's ``pyr_down`` and
    ``subsample_depth_with_holes`` applied twice and to ``pyramid_ref``,
    from float32 and from uint8 gray with uint16 raw depth (scaled as the
    front end scales it), over depth with holes and NaN (W % 16 != 0 at 79
    and 65 columns, odd H).  A third lane adds inf depth, held to the plain
    version alone: JAX's selector matmuls spread an inf along its row and
    column (0 * inf), the port keeps it in its block."""
    h, w = shape
    inv = 1.0 / 5000.0
    gray, raw, metres = pyr_lanes(shape)
    for g_in, d_in, d_float in ((gray, metres, metres),
                                (gray.astype(np.uint8), raw, raw.astype(np.float32) * np.float32(inv))):
        ref = tfilt.pyramid_ref(torch.from_numpy(g_in), torch.from_numpy(d_in), inv, 3)
        np.testing.assert_array_equal(ref[0][0].numpy(), gray)
        np.testing.assert_array_equal(ref[0][1].numpy(), d_float)
        for i in range(3):
            got = model_pyramid(gray[i], d_float[i], 3)
            jg, jd = jnp.asarray(gray[i]), jnp.asarray(d_float[i])
            for lvl in (1, 2):
                np.testing.assert_array_equal(got[lvl][0], ref[lvl][0][i].numpy())
                np.testing.assert_array_equal(got[lvl][1], ref[lvl][1][i].numpy())
                jg, jd = jfilt.pyr_down(jg), jdepth.subsample_depth_with_holes(jd)
                np.testing.assert_array_equal(got[lvl][0], np.asarray(jg))
                if i < 2:
                    np.testing.assert_array_equal(got[lvl][1], np.asarray(jd))
        assert np.isinf(ref[1][1][2].numpy()).any() or d_in.dtype == np.uint16


@pytest.mark.parametrize("n_levels", [2, 4])
def test_pyramid_levels(n_levels):
    """2 levels (one launch of one step) and 4 (two steps, then one from
    level 2): every level bit-equal to ``pyramid_ref`` at 160x120 and 61x79,
    whose depth levels (30x39, 15x19, 7x9) are smaller than the gray's
    (31x40, 16x20, 8x10): each launch takes the depth's own size."""
    for shape in (SHAPES[0], SHAPES[1]):
        gray, _, metres = pyr_lanes(shape)
        ref = tfilt.pyramid_ref(torch.from_numpy(gray), torch.from_numpy(metres), 1.0, n_levels)
        assert len(ref) == n_levels
        for i in range(2):
            got = model_pyramid(gray[i], metres[i], n_levels)
            for lvl in range(1, n_levels):
                np.testing.assert_array_equal(got[lvl][0], ref[lvl][0][i].numpy())
                np.testing.assert_array_equal(got[lvl][1], ref[lvl][1][i].numpy())
        if shape == SHAPES[1] and n_levels == 4:
            assert [tuple(x.shape[1:]) for lv in ref[1:] for x in lv] == [
                (31, 40), (30, 39), (16, 20), (15, 19), (8, 10), (7, 9)]


@pytest.mark.parametrize("shape", [(5, 5), (6, 9), (11, 7), (33, 130), (20, 300)])
def test_pyramid_small_and_wide(shape):
    """Levels below one tile (5x5: a first step of 3x3, a second of 2x2),
    odd and even sizes, a tile's edge inside the image's halo (33 rows: a
    second tile of one row) and a wide image of several tiles a row: the
    model's reads stay in its window and tile, every pixel is written once,
    and the levels are ``pyramid_ref``'s."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    gray = np.round(rng.random((h, w)) * 255).astype(np.float32)
    depth = (rng.random((h, w)) * 4).astype(np.float32)
    depth[rng.random((h, w)) < 0.3] = 0.0
    ref = tfilt.pyramid_ref(torch.from_numpy(gray)[None], torch.from_numpy(depth)[None], 1.0, 3)
    stats = {}
    got = model_pyramid(gray, depth, 3, stats)
    h2, w2 = ref[2][0].shape[1:]
    assert stats["blocks"] == -(-h2 // PYR_TH) * -(-w2 // PYR_TW)
    for lvl in (1, 2):
        np.testing.assert_array_equal(got[lvl][0], ref[lvl][0][0].numpy())
        np.testing.assert_array_equal(got[lvl][1], ref[lvl][1][0].numpy())


def test_pyramid_refuses_small_steps():
    """``pyramid`` refuses a step whose input is below 3x3 before it routes
    (4x4 at 3 levels: level 1 is 2x2), as REFLECT_101 needs, and takes 4x4
    at 2 levels; one level is level 0 as float32, with no step."""
    g = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="at least 3x3"):
        tfilt.pyramid(g, g, 1.0, 3)
    assert [tuple(x.shape) for lv in tfilt.pyramid(g, g, 1.0, 2) for x in lv] == [
        (1, 4, 4), (1, 4, 4), (1, 2, 2), (1, 2, 2)]
    raw = torch.full((1, 4, 4), 5000, dtype=torch.int32).to(torch.uint16)
    (g0, d0), = tfilt.pyramid(g.to(torch.uint8), raw, 1.0 / 5000.0, 1)
    assert g0.dtype == d0.dtype == torch.float32 and (d0 == np.float32(5000) * np.float32(
        1.0 / 5000.0)).all()


# -- the fill-in --------------------------------------------------------------------


def _fill_chunks(base: int, i0: int, i1: int):
    """fill_walk's chunks (i, m) of bytes [i0, i1) of a lane whose byte 0
    lies at address ``base``: the short head up to the first 16-byte
    boundary, whole chunks, the short tail."""
    if i1 <= i0:
        return []
    head = min((16 - (base + i0) % 16) % 16, i1 - i0)
    a0 = i0 + head
    a1 = a0 + ((i1 - a0) & ~15)
    return ([(i0, head)] if head else []) + [(c, 16) for c in range(a0, a1, 16)] + (
        [(a1, i1 - a1)] if a1 < i1 else [])


def _chunk_bytes(chunks) -> np.ndarray:
    return np.concatenate([np.arange(i, i + m) for i, m in chunks] or [np.zeros(0, int)])


def model_fill(levels, patches, n_percentage, cluster, slots, base=0):
    """revo_fill_levels on one lane's levels (numpy bool, level 0 first) as
    its blocks run it: (levels 1 on after the fill-in, flags)."""
    out, flags, parent = [], [], levels[0]
    for lvl in range(1, len(levels)):
        e = levels[lvl]
        h, w = e.shape
        p, pp = patches[lvl], patches[lvl - 1]
        hc, wc = h // p, w // p
        wcw = (wc + 31) // 32
        thresh = np.float32(p * p * 0.05)
        flat = e.reshape(-1)
        bits = np.zeros((hc, wcw), np.int64)
        seen = np.zeros(h * w, int)
        nnz = 0
        for k in range(cluster):
            r0, r1 = hc * k // cluster, hc * (k + 1) // cluster
            tc = min(wc, slots)
            tr = max(slots // max(wc, 1), 1) if tc == wc else 1
            for t0 in range(r0, r1, tr):
                t1 = min(t0 + tr, r1)
                for c0 in range(0, wc, tc):
                    c1 = min(c0 + tc, wc)
                    idx = _chunk_bytes(_fill_chunks(base, t0 * p * w, t1 * p * w))
                    assert np.array_equal(idx, np.arange(t0 * p * w, t1 * p * w))
                    y, x = np.divmod(idx, w)
                    hit = flat[idx] & (x >= c0 * p) & (x < c1 * p)
                    seen[idx[hit]] += 1
                    counts = np.bincount(((y // p - t0) * tc + x // p - c0)[hit],
                                         minlength=(t1 - t0) * tc)
                    assert counts.size == (t1 - t0) * tc  # every slot inside the tile
                    for rr in range(t1 - t0):
                        for j in range(c0 // 32, (c1 + 31) // 32):
                            bx = 32 * j + np.arange(32)
                            cnt = np.where(bx < c1, counts[rr * tc + np.minimum(bx, c1 - 1) - c0],
                                           0)
                            sparse = (bx < c1) & (cnt.astype(np.float32) < thresh)
                            bits[t0 + rr, j] = int((sparse << np.arange(32)).sum())
                            nnz += int((cnt > 0).sum())
        inside = np.zeros((h, w), bool)
        inside[:hc * p, :wc * p] = True
        np.testing.assert_array_equal(seen, (e & inside).reshape(-1))  # counted once each
        with np.errstate(invalid="ignore"):
            fill = bool(np.float32(nnz) / np.float32(hc * wc) < np.float32(n_percentage))
        res = np.full(h * w, -1, np.int64)
        ph, pw = parent.shape
        for k in range(cluster):
            idx = _chunk_bytes(_fill_chunks(base, h * k // cluster * w, h * (k + 1) // cluster * w))
            assert (res[idx] == -1).all()  # written once
            res[idx] = flat[idx]
            if fill:
                y, x = np.divmod(idx, w)
                py, px = 2 * y + 1, 2 * x + 1
                inpar = (py < ph) & (px < pw)
                pb = np.zeros(idx.size, bool)
                pb[inpar] = parent[py[inpar], px[inpar]]
                by, bx = np.minimum(py // pp, hc - 1), np.minimum(px // pp, wc - 1)
                bit = np.zeros(idx.size, bool)
                bit[pb] = (bits[by[pb], bx[pb] >> 5] >> (bx[pb] & 31)) & 1
                res[idx] |= pb & bit
        assert (res >= 0).all()
        e = res.reshape(h, w).astype(bool)
        out.append(e)
        flags.append(fill)
        parent = e
    return out, flags


def jax_fill(levels, patches, n_percentage):
    """JAX's build_frame fill-in (revo_tpu/frontend.py:99-110), one lane."""
    out, flags, parent = [], [], jnp.asarray(levels[0])
    for lvl in range(1, len(levels)):
        edges = jnp.asarray(levels[lvl])
        counts, occupancy = jhist.patch_histogram(edges, patches[lvl])
        filled = jhist.fill_in_edges(edges, parent, counts, patches[lvl], patches[lvl - 1])
        edges = jnp.where(occupancy < n_percentage, filled, edges)
        out.append(np.asarray(edges))
        flags.append(bool(occupancy < n_percentage))
        parent = edges
    return out, flags


def fill_lanes(shape):
    """Lanes of pyramid levels (3): Canny 60/20 and 150/100 of a synthetic
    image's pyrDown levels, no edge, all edges, sparse random edges."""
    img = synthetic_gray(*shape, seed=7)
    sizes, grays = [shape], [img]
    for _ in range(2):
        grays.append(cv2.pyrDown(grays[-1]))
        sizes.append(grays[-1].shape)
    rng = np.random.default_rng(shape[0])
    return [[cv2.Canny(g, hi, lo, apertureSize=3, L2gradient=True) > 0 for g in grays]
            for hi, lo in ((60, 20), (150, 100))] + [
        [np.zeros(s, bool) for s in sizes], [np.ones(s, bool) for s in sizes],
        [rng.random(s) < d for s, d in zip(sizes, (0.05, 0.002, 0.004))]]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cluster, slots, base", [(1, FILL_COUNTS_MAX, 0), (2, 32, 5),
                                                  (4, 64, 0), (16, FILL_COUNTS_MAX, 11)])
def test_fill_levels(shape, cluster, slots, base):
    """The fill-in's blocks, tiles, bit map and chunks against JAX's
    sequence and the plain version, lane by lane, for clusters of 1-16
    blocks, count slots of 32 (tiles of part of a bin row), 64 and the most,
    and lanes whose first byte is not 16-byte aligned.  Slots of 32 and 64
    stand for FILL_COUNTS_MAX on levels whose bin rows pass it (the card's
    tests reach those tiles with such levels)."""
    patches, n_pct = (20, 10, 5), 0.3
    lanes = fill_lanes(shape)
    plain, plain_flags = thist.fill_in_levels_ref(
        [torch.from_numpy(np.stack([lane[k] for lane in lanes])) for k in range(3)], patches,
        n_pct)
    filled = 0
    for i, lane in enumerate(lanes):
        got, flags = model_fill(lane, patches, n_pct, cluster, slots, base)
        want, want_flags = jax_fill(lane, patches, n_pct)
        assert flags == want_flags == plain_flags[i].tolist()
        for g, w_, pl in zip(got, want, plain):
            np.testing.assert_array_equal(g, w_)
            np.testing.assert_array_equal(g, pl[i].numpy())
        filled += sum(flags)
    assert filled > 0


def test_fill_levels_small_patches_and_long_rows():
    """Patches of 1-3 pixels (a bin row wider than the count slots; bins of
    the parent's patch that the child's lookup clamps) and more levels than
    one launch takes, as the wrapper chains them: the model against JAX."""
    rng = np.random.default_rng(3)
    sizes = [(96, 200)]
    while len(sizes) < FILL_MAX_LEVELS + 2:
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    patches = (3, 2, 1, 3, 2, 1, 1, 1, 1, 1)
    levels = [rng.random(s) < d for s, d in zip(sizes, np.linspace(0.02, 0.4, len(sizes)))]
    want, want_flags = jax_fill(levels, patches, 0.3)
    got, flags = [], []
    for s in range(0, len(levels) - 1, FILL_MAX_LEVELS - 1):
        group = list(range(s, min(s + FILL_MAX_LEVELS, len(levels))))
        first = levels[0] if s == 0 else got[s - 1]
        g, f = model_fill([first] + [levels[i] for i in group[1:]],
                          [patches[i] for i in group], 0.3, 4, 64, 3)
        got += g
        flags += f
    assert flags == want_flags and any(flags) and not all(flags)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


# -- routing ----------------------------------------------------------------------


def _wrappers(device):
    e = torch.zeros((2, 9, 11), dtype=torch.bool, device=device)
    d = torch.ones((2, 9, 11), device=device)
    return {
        "edt_columns_levels": (tedt.edt_columns_levels,
                               lambda: tedt.edt_columns_levels([e, e[:, :5, :6]])),
        "keyframe_rows": (tedt.keyframe_rows, lambda: tedt.keyframe_rows(d, "dt4bf")),
        "keyframe_tables": (tedt.keyframe_rows, lambda: tedt.keyframe_tables([e, e], "flat")),
        "backproject_edges": (tbp.backproject_edges,
                              lambda: tbp.backproject_edges(e, d, capacity=16, **CAM)),
        "pyramid": (tfilt.pyramid, lambda: tfilt.pyramid(d, d, 1.0, 2)),
        "fill_in_levels": (thist.fill_in_levels,
                           lambda: thist.fill_in_levels([e, e[:, :5, :6]], (2, 2), 0.3)),
    }


@pytest.mark.parametrize("name", ["edt_columns_levels", "keyframe_rows", "keyframe_tables",
                                  "backproject_edges", "pyramid", "fill_in_levels"])
def test_routing(name):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any other device than the CPU or a CUDA card raises, as do tensors
    on two devices."""
    counter, fn = _wrappers("cpu")[name]
    before = counter.launches
    fn()
    assert counter.launches == before
    for other in (tedt.edt_columns_levels, tedt.keyframe_rows, tbp.backproject_edges,
                  tfilt.pyramid, thist.fill_in_levels):
        assert other.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        _wrappers("meta")[name][1]()
    e = torch.zeros((1, 9, 11), dtype=torch.bool)
    with pytest.raises(ValueError, match="different devices"):
        tbp.backproject_edges(e, torch.ones((1, 9, 11), device="meta"), capacity=4, **CAM)
    with pytest.raises(ValueError, match="different devices"):
        tfilt.pyramid(torch.ones((1, 9, 11)), torch.ones((1, 9, 11), device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        tedt.edt_columns_levels([e, e.to("meta")])
