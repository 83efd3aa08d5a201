"""A numpy model of ``canny_fused``'s kernel (revo_tpu_torch/csrc/canny.cu,
``canny_fused_kernel``): K1 by warps over strips of 32 columns by 8 rows,
the packed words, the ticket, and K2's synchronous steps evaluated on the
frontier only.  Imports no jax, so the card's tests can hold the kernel's
step counts to it.

K1: lane l of the warp owns column x0 + l; lanes 0, 1, 30, 31 also read
columns x0 - 1, x0 - 2, x0 + 33, x0 + 32, and lanes 0 and 31 receive their
outer neighbour by shuffle; the Sobel is the kernel's horizontal and
vertical smoothings in float32, the magnitude 0 outside the image, and a
ballot a row.  K2: two state buffers that start as strong, the words that
changed at a step as dirty bits a word (bit i of dirty word j of a row is
word 32 j + i; the first step's: the strong words that are not 0), the
next step evaluating only the words in the 3x3 word neighbourhood of those
that still have a cand bit to reach or that changed themselves, and
writing only those into the other buffer, so that a fault in that argument
would leave a stale word in the result.  Trips of 8, a step that grows
nothing ends its trip, cap H + W.
"""
import numpy as np

FS_ROWS = 8  # output rows of a K1 strip (csrc/canny.cu FS_ROWS)
WARPS = 32   # warps of a 1024-thread block
TG22 = np.float32(0.41421356237309504880)
TG67 = np.float32(2.41421356237309504880)


def reflect_gray(gray: np.ndarray, y, x) -> np.ndarray:
    """ReflectGray: gray at (y, x) with REFLECT_101 on the index one pixel
    out, 0 further out; float32."""
    h, w = gray.shape
    y, x = np.broadcast_arrays(np.asarray(y), np.asarray(x))
    out_of = (y < -1) | (y > h) | (x < -1) | (x > w)
    yy = np.where(y < 0, -y, np.where(y >= h, 2 * h - 2 - y, y))
    xx = np.where(x < 0, -x, np.where(x >= w, 2 * w - 2 - x, x))
    vals = gray[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32)
    return np.where(out_of, np.float32(0), vals).astype(np.float32)


def _up(v):  # __shfl_up_sync by 1: lane l gets lane l - 1's value, lane 0 its own
    return np.concatenate([v[..., :1], v[..., :-1]], -1)


def _down(v):  # __shfl_down_sync by 1: lane l gets lane l + 1's, lane 31 its own
    return np.concatenate([v[..., 1:], v[..., -1:]], -1)


def _sector(gx, gy):
    ax, ay = np.abs(gx), np.abs(gy)
    horizontal = ay < ax * TG22
    vertical = ay > ax * TG67
    falling = gx * gy >= 0
    return np.where(horizontal, 0, np.where(vertical, 1, np.where(falling, 2, 3)))


def classify_strip(gray: np.ndarray, x0: int, y0: int, low_sq: float, high_sq: float):
    """One warp's strip: ({row: (cand word, strong word)} for the rows of
    y0 .. y0 + FS_ROWS - 1 inside the image)."""
    h, w = gray.shape
    f32 = np.float32
    lane = np.arange(32)
    x = x0 + lane
    xe = np.where(lane == 0, x0 - 1, np.where(lane == 1, x0 - 2,
                                               np.where(lane == 30, x0 + 33, x0 + 32)))
    has_e = (lane <= 1) | (lane >= 30)
    xo = np.where(lane == 0, x0 - 1, x0 + 32)
    col_in, outer_in = x < w, (xo >= 0) & (xo < w)
    ys = y0 - 2 + np.arange(FS_ROWS + 4)[:, None]
    g = reflect_gray(gray, ys, x[None])
    e = np.where(has_e, reflect_gray(gray, ys, xe[None]), f32(0))
    f = np.where(lane == 0, _down(e), _up(e))
    hs = np.where(lane == 0, e, _up(g)) + f32(2) * g + np.where(lane == 31, e, _down(g))
    ho = np.where(lane == 0, f + f32(2) * e + g, g + f32(2) * e + f)
    mags, left, right, secs = [], [], [], []
    for i in range(FS_ROWS + 2):  # magnitude row y0 - 1 + i from gray rows i .. i + 2
        ym = y0 - 1 + i
        row_in = 0 <= ym < h
        v = g[i] + f32(2) * g[i + 1] + g[i + 2]
        vo = e[i] + f32(2) * e[i + 1] + e[i + 2]
        voo = f[i] + f32(2) * f[i + 1] + f[i + 2]
        gx = np.where(lane == 31, vo, _down(v)) - np.where(lane == 0, vo, _up(v))
        gy = hs[i + 2] - hs[i]
        m = np.where(row_in & col_in, gx * gx + gy * gy, f32(0))
        gxo = np.where(lane == 0, v - voo, voo - v)
        gyo = ho[i + 2] - ho[i]
        mo = np.where(row_in & outer_in, gxo * gxo + gyo * gyo, f32(0))
        mags.append(m)
        left.append(np.where(lane == 0, mo, _up(m)))
        right.append(np.where(lane == 31, mo, _down(m)))
        secs.append(_sector(gx, gy))
    words = {}
    for i in range(1, FS_ROWS + 1):
        yc = y0 - 1 + i
        if yc >= h:
            continue
        sec, m = secs[i], mags[i]
        first = np.select([sec == 0, sec == 1, sec == 2], [left[i], mags[i - 1], left[i - 1]],
                          right[i - 1])
        second = np.select([sec == 0, sec == 1, sec == 2], [right[i], mags[i + 1], right[i + 1]],
                           left[i + 1])
        keep = (m > first) & np.where(sec <= 1, m >= second, m > second)
        c = col_in & keep & (m > low_sq)
        s = c & (m > high_sq)
        words[yc] = (int(np.sum(c.astype(np.int64) << lane)), int(np.sum(s.astype(np.int64) << lane)))
    return words


def strip_owners(h: int, w: int, blocks: int):
    """(block, warp, strip) of every strip one image's ``blocks`` blocks
    classify: warp w of block x takes strips x + blocks (w + 32 i)."""
    wpr = -(-w // 32)
    strips = wpr * -(-h // FS_ROWS)
    return [(x, warp, s) for x in range(blocks) for warp in range(WARPS)
            for s in range(x + blocks * warp, strips, blocks * WARPS)]


def k1_words(gray: np.ndarray, low_sq: float, high_sq: float, blocks: int):
    """The packed (cand, strong) words (H, ceil(W / 32)) the image's blocks
    store; every word is stored exactly once."""
    h, w = gray.shape
    wpr = -(-w // 32)
    words = np.zeros((2, h, wpr), np.uint32)
    stored = np.zeros((h, wpr), int)
    for _, _, s in strip_owners(h, w, blocks):
        band, k = divmod(s, wpr)
        for y, (cb, sb) in classify_strip(gray, 32 * k, band * FS_ROWS, low_sq, high_sq).items():
            words[0, y, k], words[1, y, k] = cb, sb
            stored[y, k] += 1
    assert (stored == 1).all()
    return words[0], words[1]


def fused_blocks(b: int, h: int, w: int, resident: int = 132) -> int:
    """``revo_canny_fused_blocks``' rule on a card that holds ``resident``
    blocks at once: resident // b, at least 1, at most one a strip."""
    strips = -(-w // 32) * -(-h // FS_ROWS)
    return min(max(1, resident // b), strips)


def pack(bits: np.ndarray, width: int) -> np.ndarray:
    """(H, n) bool -> (H, ceil(n / 32)) uint32, bit i of word j = column
    32 j + i; ``width`` words a row (zero words past n)."""
    h, n = bits.shape
    padded = np.zeros((h, 32 * width), np.uint32)
    padded[:, :n] = bits
    return (padded.reshape(h, width, 32) << np.arange(32, dtype=np.uint32)).sum(
        -1, dtype=np.uint32)


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].astype(bool)


def _dilate_rows(s: np.ndarray) -> np.ndarray:
    left, right = np.zeros_like(s), np.zeros_like(s)
    left[:, 1:] = s[:, :-1] >> 31
    right[:, :-1] = s[:, 1:] << 31
    return s | (s << 1) | (s >> 1) | left | right


def _rows3(a: np.ndarray) -> np.ndarray:
    out = a.copy()
    out[1:] |= a[:-1]
    out[:-1] |= a[1:]
    return out


def frontier_bits(d: np.ndarray) -> np.ndarray:
    """The dirty words ORed over three rows, dilated by one bit with carries
    across dirty words (csrc/canny.cu frontier_bits)."""
    return _dilate_rows(_rows3(d))


def frontier_fixpoint(c: np.ndarray, strong: np.ndarray, h: int, w: int, cap=None):
    """K2 of the kernel on packed (H, ceil(W / 32)) words -> ((H, W) bool,
    steps run, largest frontier, words evaluated in all)."""
    wpr = c.shape[1]
    dpr = -(-wpr // 32)
    cap = h + w if cap is None else cap
    bufs = [strong.copy(), strong.copy()]
    dirty = [pack(strong != 0, dpr), np.zeros((h, dpr), np.uint32)]
    cur = it = steps = most = total = 0
    trip_grew = True
    while trip_grew and it < cap:
        trip_grew = False
        for _ in range(8):
            src, dst = bufs[cur], bufs[cur ^ 1]
            near = unpack(frontier_bits(dirty[cur]), wpr)
            own = unpack(dirty[cur], wpr)
            evaluated = near & (((c & ~src) != 0) | own)
            now = src | (c & _rows3(_dilate_rows(src)))
            dst[evaluated] = now[evaluated]
            # The argument the kernel rests on: a word left out holds the
            # same value in both buffers, and would not have changed.
            assert (dst[~evaluated] == src[~evaluated]).all()
            assert (now[~evaluated] == src[~evaluated]).all()
            changed = evaluated & (now != src)
            dirty[cur ^ 1] = pack(changed, dpr)
            work = int(evaluated.sum())
            most, total = max(most, work), total + work
            cur ^= 1
            steps += 1
            if not changed.any():
                break
            trip_grew = True
        it += 8
    return unpack(bufs[cur], w), steps, most, total


def fused_kernel_model(gray: np.ndarray, low: float, high: float, blocks=None):
    """What ``revo_canny_fused`` does to one (H, W) image: (edges (H, W)
    bool, steps, largest frontier, words evaluated)."""
    h, w = gray.shape
    blocks = fused_blocks(1, h, w) if blocks is None else blocks
    c, s = k1_words(gray, low * low, high * high, blocks)
    return frontier_fixpoint(c, s, h, w)
