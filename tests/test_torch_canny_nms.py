"""K1 ``canny_nms`` on the CPU: the port's wrapper from unpadded gray against
JAX's ``_nms_batched`` (interpret mode), and a numpy model of the CUDA
kernel's tile walk against the plain version.  The kernel itself against
its plain version on the card is in test_torch_cuda.py.

The model follows ``revo_canny_nms`` (csrc/canny.cu): persistent blocks, block
g taking tiles g, g + G, ... of the B x ceil(H / 64) x ceil(W / 128) tiles
(column fastest); a tile stages rows y0 - 2 .. y0 + 65 and columns x0 - A ..
x0 + 127 + A of the gray in its own type, A one 16-byte chunk of elements
(16 for uint8, 4 for float32).  A tile whose staged window lies inside the
image is interior and is read with no bounds test, by 16-byte copies where
the rows are whole aligned chunks ("vector"), else by plain loads
("scalar"); any other tile ("border") reads through REFLECT_101 on the
index, 0 beyond one pixel out.  The model classifies each tile from its
staged window alone, with ``canny_nms_ref`` on the window of the tile's
1-px ring (clipped to the image) padded by the staged pixels around it.

Tolerance: bit-equal throughout (masks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.ops.pallas.canny_kernel import _nms_batched
from revo_tpu_torch.ops import canny as K12
from revo_tpu_torch.ops.filters import _reflect_pad

from test_ops import synthetic_gray

torch.set_num_threads(1)

TY, TX = K12.NMS_TILE
LOW_SQ, HIGH_SQ = 100.0 ** 2, 150.0 ** 2


def _grays(b, h, w, seed=0):
    """B uint8 images: the synthetic scene where it is large enough, else
    seeded noise with a bright block (edges in any window)."""
    if h >= 64 and w >= 64:
        return np.stack([synthetic_gray(h=h, w=w, seed=seed + i) for i in range(b)])
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, size=(b, h, w)).astype(np.uint8)
    g[:, h // 3:, w // 2:] = 250
    return g


def nms_path(y0, x0, h, w, elem, aligned):
    """The staging path of the tile at (y0, x0), as the kernel picks it."""
    a = 16 // elem
    interior = y0 >= 2 and y0 + TY + 2 <= h and x0 >= a and x0 + TX + a <= w
    if not interior:
        return "border"
    return "vector" if (w * elem) % 16 == 0 and aligned else "scalar"


def tile_walk(b, h, w, grid, elem=1, aligned=True):
    """Per block of a ``grid``-block launch, its tiles in the order it takes
    them: (tile index, image, y0, x0, path)."""
    ntx, nty = -(-w // TX), -(-h // TY)
    per_img, n = ntx * nty, b * ntx * nty
    walk = []
    for g in range(grid):
        mine = []
        for t in range(g, n, grid):
            i, r = divmod(t, per_img)
            ty, tx = divmod(r, ntx)
            mine.append((t, i, ty * TY, tx * TX, nms_path(ty * TY, tx * TX, h, w, elem, aligned)))
        walk.append(mine)
    return walk


def stage(img, y0, x0, path, elem):
    """The tile's staged window of one (H, W) image, in its own type."""
    h, w = img.shape
    a = 16 // elem
    if path != "border":
        st = img[y0 - 2:y0 + TY + 2, x0 - a:x0 + TX + a]
        assert st.shape == (TY + 4, TX + 2 * a)  # an interior read stays inside the image
        return st
    ys, xs = np.arange(y0 - 2, y0 + TY + 2), np.arange(x0 - a, x0 + TX + a)

    def reflect(v, n):
        return np.where(v < 0, -v, np.where(v >= n, 2 * n - 2 - v, v))

    ry, rx = reflect(ys, h), reflect(xs, w)
    out = img[np.ix_(np.clip(ry, 0, h - 1), np.clip(rx, 0, w - 1))].copy()
    out[(ys < -1) | (ys > h), :] = 0
    out[:, (xs < -1) | (xs > w)] = 0
    return out


def kernel_model(gray, low_sq, high_sq, grid, aligned=True):
    """What ``revo_canny_nms`` writes for (B, H, W) ``gray`` over ``grid``
    blocks, and how many times each pixel was written."""
    b, h, w = gray.shape
    elem = gray.dtype.itemsize
    a = 16 // elem
    cand, strong = np.zeros(gray.shape, bool), np.zeros(gray.shape, bool)
    written = np.zeros(gray.shape, np.int32)
    for mine in tile_walk(b, h, w, grid, elem, aligned):
        for _, i, y0, x0, path in mine:
            st = stage(gray[i], y0, x0, path, elem).astype(np.float32)
            # The tile's 1-px ring clipped to the image, in staged coordinates,
            # padded by one staged pixel a side.
            ya, yb = max(y0 - 1, 0), min(y0 + TY + 1, h)
            xa, xb = max(x0 - 1, 0), min(x0 + TX + 1, w)
            sy, sx = ya - (y0 - 2), xa - (x0 - a)
            win = st[sy - 1:sy + (yb - ya) + 1, sx - 1:sx + (xb - xa) + 1]
            c, s = (m[0].numpy() for m in K12.canny_nms_ref(
                torch.from_numpy(np.ascontiguousarray(win))[None], low_sq, high_sq))
            ty1, tx1 = min(y0 + TY, h), min(x0 + TX, w)
            cand[i, y0:ty1, x0:tx1] = c[y0 - ya:ty1 - ya, x0 - xa:tx1 - xa]
            strong[i, y0:ty1, x0:tx1] = s[y0 - ya:ty1 - ya, x0 - xa:tx1 - xa]
            written[i, y0:ty1, x0:tx1] += 1
    return cand, strong, written


def _plain(gray, low_sq=LOW_SQ, high_sq=HIGH_SQ):
    gp = _reflect_pad(torch.from_numpy(gray).to(torch.float32), 1, 1)
    return (m.numpy() for m in K12.canny_nms_ref(gp, low_sq, high_sq))


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", [(120, 160), (29, 37), (2, 2)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_canny_nms_matches_pallas_nms_batched(b, shape, dtype):
    """From unpadded gray, uint8 and float32: bit-equal to JAX's K1 on the
    REFLECT_101-padded float32 copy, its single-image call at B = 1
    (canny_kernel.py:148) and its grid call at B = 3 (:166)."""
    gray = _grays(b, *shape, seed=4).astype(dtype)
    before = K12.canny_nms.launches
    cand, strong = K12.canny_nms(torch.from_numpy(gray), LOW_SQ, HIGH_SQ)
    assert K12.canny_nms.launches == before  # no kernel launch on the CPU
    gp = jnp.pad(jnp.asarray(gray).astype(jnp.float32), ((0, 0), (1, 1), (1, 1)), mode="reflect")
    want_c, want_s = (np.asarray(m) > 0.5 for m in _nms_batched(gp, LOW_SQ, HIGH_SQ))
    assert cand.dtype == torch.bool and cand.shape == (b, *shape)
    np.testing.assert_array_equal(cand.numpy(), want_c)
    np.testing.assert_array_equal(strong.numpy(), want_s)
    if shape[0] > 2:
        assert want_c.any() and want_s.any()


@pytest.mark.parametrize("shape", [(1, 1, 5), (1, 5, 1), (2, 1, 1), (5, 5)])
def test_canny_nms_rejects_what_reflect_cannot_pad(shape):
    """H or W below 2 (REFLECT_101 needs two pixels), or no batch axis."""
    with pytest.raises(ValueError):
        K12.canny_nms(torch.zeros(shape, dtype=torch.uint8), LOW_SQ, HIGH_SQ)


@pytest.mark.parametrize("b, h, w, elem, aligned, grid", [
    (1, 480, 640, 1, True, 792), (1, 480, 640, 4, True, 7), (3, 37, 53, 1, True, 2),
    (2, 140, 2051, 1, True, 5), (1, 5, 300, 4, True, 1), (3, 140, 644, 4, True, 11),
    (1, 140, 642, 4, True, 4), (1, 140, 640, 1, False, 3)])
def test_tile_walk_covers_every_tile_once(b, h, w, elem, aligned, grid):
    """Every tile is taken by exactly one block, each block in strides of
    the grid; the path follows the window and the alignment."""
    walk = tile_walk(b, h, w, grid, elem, aligned)
    tiles = [t for mine in walk for t, *_ in mine]
    assert sorted(tiles) == list(range(K12.nms_tiles(b, h, w)))
    for g, mine in enumerate(walk):
        assert [t for t, *_ in mine] == list(range(g, len(tiles), grid))
    a = 16 // elem
    for _, _, y0, x0, path in (x for mine in walk for x in mine):
        inside = 2 <= y0 and y0 + TY + 2 <= h and a <= x0 and x0 + TX + a <= w
        assert (path == "border") == (not inside)
        if path != "border":
            assert (path == "vector") == ((w * elem) % 16 == 0 and aligned)
    paths = {p for mine in walk for *_, p in mine}
    if (h, w) in ((480, 640), (140, 644), (140, 640)):
        assert paths == {"border", "vector" if aligned else "scalar"}
    if (h, w) in ((140, 2051), (140, 642)):
        assert paths == {"border", "scalar"}
    if h < TY + 4 or w < TX + 2 * a:
        assert paths == {"border"}


@pytest.mark.parametrize("b, h, w, dtype, grid, aligned, paths", [
    (1, 120, 160, np.uint8, 1, True, {"border"}),        # one block walks every tile
    (1, 140, 300, np.float32, 5, True, {"border", "vector"}),  # rows of whole chunks
    (3, 37, 53, np.uint8, 4, True, {"border"}),          # ragged
    (1, 140, 2051, np.uint8, 7, True, {"border", "scalar"}),  # ragged width: plain loads
    (2, 5, 140, np.float32, 3, True, {"border"}),        # H below one tile
    (1, 70, 290, np.uint8, 100, True, {"border"}),       # more blocks than tiles
    (1, 140, 304, np.uint8, 3, False, {"border", "scalar"}),  # unaligned base
])
def test_kernel_model_is_the_plain_version(b, h, w, dtype, grid, aligned, paths):
    """The tile walk, each tile classified from its staged window alone,
    takes the paths named, writes every pixel exactly once and is bit-equal
    to ``canny_nms_ref`` on the whole image."""
    gray = _grays(b, h, w, seed=2).astype(dtype)
    walk = tile_walk(b, h, w, grid, gray.dtype.itemsize, aligned)
    assert {p for mine in walk for *_, p in mine} == paths
    cand, strong, written = kernel_model(gray, LOW_SQ, HIGH_SQ, grid, aligned)
    assert (written == 1).all()
    want_c, want_s = _plain(gray)
    np.testing.assert_array_equal(cand, want_c)
    np.testing.assert_array_equal(strong, want_s)
    assert want_c.any()
