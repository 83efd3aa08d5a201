"""``canny_cluster`` on the CPU: a numpy model of the cluster kernel's data
flow against the plain version and JAX's Pallas kernels (interpret mode),
the shape routing of ``canny_batched``, and the wrapper's CPU contract.
The kernel itself against its plain version on the card is in
test_torch_cuda.py.

The model follows ``revo_canny_cluster`` (csrc/canny.cu): R ranks, rank r
owning rows [r rb, min((r + 1) rb, H)) with rb = ceil(H / R), so the last
ranks may own none; K1 in 256 x 16 tiles from the band's first row, a warp
storing the words of one row when that row lies in its band; K2's
synchronous steps on each band, the row above and the row below read from
the neighbouring ranks' source buffers, one cluster-wide "grew" per step,
trips of 8, a step that grows nothing ends the loop, cap H + W.

Tolerance: bit-equal throughout (masks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.ops.pallas.canny_kernel import canny_pallas
from revo_tpu.ops.pallas.hysteresis import hysteresis_pallas
from revo_tpu_torch.ops import canny as K12

from test_ops import synthetic_gray
from test_torch_kernels import ballot_words

torch.set_num_threads(1)

CL_TX, CL_TY, THREADS = 256, 16, 1024  # the kernel's K1 tile and block
H100_SMEM = 232448  # opt-in shared memory of one H100 block


def _t(a):
    return torch.from_numpy(np.array(a))


def bands(h: int, ranks: int):
    """Rows [y0, y1) of each rank's band."""
    rb = -(-h // ranks)
    return [(min(r * rb, h), min(r * rb + rb, h)) for r in range(ranks)]


def _dilate_rows(s: np.ndarray) -> np.ndarray:
    left, right = np.zeros_like(s), np.zeros_like(s)
    left[:, 1:] = s[:, :-1] >> 31
    right[:, :-1] = s[:, 1:] << 31
    return s | (s << 1) | (s >> 1) | left | right


def _unpack(words: np.ndarray, w: int) -> np.ndarray:
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :w].astype(bool)


def cluster_fixpoint(c: np.ndarray, state: np.ndarray, h: int, w: int,
                     ranks: int) -> np.ndarray:
    """K2 of the cluster kernel on packed (H, ceil(W / 32)) words of cand
    and strong -> (H, W) bool: each rank steps its band, reading its halo
    rows from its neighbours' source buffers (row rb - 1 of rank r - 1, row
    0 of rank r + 1; zero at the image's edges), and every rank reads one
    OR of all ranks' growth per step."""
    wpr = c.shape[1]
    rb = -(-h // ranks)
    spans = bands(h, ranks)
    zero = np.zeros((1, wpr), np.uint32)
    src = [state[y0:y1].copy() for y0, y1 in spans]
    it, trip_grew = 0, True
    while trip_grew and it < h + w:
        trip_grew = False
        for _ in range(8):
            dst, grew = [], False
            for r, (y0, y1) in enumerate(spans):
                if y1 == y0:  # an empty band steps nothing, but joins the barrier
                    dst.append(src[r])
                    continue
                above = src[r - 1][rb - 1:rb] if r > 0 else zero
                below = src[r + 1][0:1] if y1 < h else zero
                hd = _dilate_rows(np.vstack([above, src[r], below]))
                new = src[r] | (c[y0:y1] & (hd[:-2] | hd[1:-1] | hd[2:]))
                grew |= bool((new != src[r]).any())
                dst.append(new)
            src = dst
            if not grew:
                break
            trip_grew = True
        it += 8
    return _unpack(np.vstack(src), w)


def cluster_k1_words(cand: np.ndarray, strong: np.ndarray, ranks: int):
    """The words K1 of the cluster kernel stores: each rank walks 256 x 16
    tiles from its band's first row over the whole width, CL_TX * CL_TY /
    THREADS pixels a thread; warp q of pass p holds 32 pixels of one row
    and stores that row's words when the row is in its band and the word
    inside the row.  Every band word must be stored exactly once."""
    h, w = cand.shape
    wpr = -(-w // 32)
    words = np.zeros((2, h, wpr), np.uint32)
    stored = np.zeros((h, wpr), int)
    packed = (ballot_words(cand), ballot_words(strong))
    for y0, y1 in bands(h, ranks):
        for ty in range(y0, y1, CL_TY):
            for tx in range(0, w, CL_TX):
                for q in range(CL_TX * CL_TY // THREADS):
                    for warp in range(THREADS // 32):
                        p = 32 * warp + q * THREADS
                        y, k = ty + p // CL_TX, (tx + p % CL_TX) // 32
                        if y < y1 and k < wpr:
                            words[0, y, k], words[1, y, k] = packed[0][y, k], packed[1][y, k]
                            stored[y, k] += 1
    assert (stored == 1).all()
    return words[0], words[1]


def cluster_kernel_model(gray: np.ndarray, low: float, high: float, ranks: int):
    """What ``revo_canny_cluster`` does to one (H, W) image: REFLECT_101 on
    the index, K1's classification, the band-wise stores, the fixpoint."""
    h, w = gray.shape

    def reflect(v, n):
        return np.where(v < 0, -v, np.where(v >= n, 2 * n - 2 - v, v))

    padded = gray.astype(np.float32)[np.ix_(reflect(np.arange(-1, h + 1), h),
                                            reflect(np.arange(-1, w + 1), w))]
    cand, strong = (m[0].numpy() for m in K12.canny_nms_ref(
        torch.from_numpy(padded)[None], low * low, high * high))
    return cluster_fixpoint(*cluster_k1_words(cand, strong, ranks), h, w, ranks)


def snake(h: int, w: int):
    """tests/test_torch_kernels.py's 1-px snake, longer than H + W from one
    seed, so the cap binds."""
    cand = np.zeros((h, w), bool)
    for y in range(0, h, 2):
        cand[y, 1:w - 1] = True
        if y + 1 < h:
            cand[y + 1, (w - 2) if (y // 2) % 2 == 0 else 1] = True
    strong = np.zeros_like(cand)
    strong[0, 1] = True
    return cand, strong


def _check_against_plain_and_pallas(cand, strong, ranks):
    h, w = cand.shape
    got = cluster_fixpoint(ballot_words(cand), ballot_words(strong), h, w, ranks)
    want = K12.hysteresis_ref(_t(cand)[None], _t(strong)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(hysteresis_pallas(jnp.asarray(cand), jnp.asarray(strong))))
    return got


class TestClusterModel:
    @pytest.mark.parametrize("h, w, ranks", [
        (40, 65, 1),    # one rank: the one-block fixpoint; ragged rows
        (33, 64, 2),    # bands of 17 and 16 rows
        (50, 37, 8),    # bands of 7, the last of 1 row; ragged
        (29, 70, 16),   # bands of 2, rank 14 one row, rank 15 empty
        (20, 96, 16),   # ranks 10-15 empty
        (64, 128, 16),  # bands of 4 that divide H
    ])
    def test_random_masks_match_plain_and_pallas(self, h, w, ranks):
        rng = np.random.default_rng(h * w + ranks)
        cand = rng.random((h, w)) < 0.45
        strong = cand & (rng.random((h, w)) < 0.03)
        got = _check_against_plain_and_pallas(cand, strong, ranks)
        assert strong.sum() < got.sum() < cand.sum()  # it grew, and not everywhere

    @pytest.mark.parametrize("ranks", [2, 8, 16])
    def test_snake_across_bands_where_the_cap_binds(self, ranks):
        """The snake's rows cross every band boundary (bands of 12, 3 and 2
        rows; at 16 ranks the last four are empty): the cluster stops at
        the pixel where the JAX loop's cap stops."""
        cand, strong = snake(24, 70)
        got = _check_against_plain_and_pallas(cand, strong, ranks)
        assert 0 < got.sum() < cand.sum()

    @pytest.mark.parametrize("h, w, ranks", [(120, 160, 16), (61, 300, 8), (37, 53, 2)])
    def test_kernel_model_from_gray(self, h, w, ranks):
        """K1 in band tiles (every band word stored once, tiles past the
        band or the right edge storing nothing) and the cluster fixpoint
        give the plain version's edges and the Pallas Canny's."""
        img = synthetic_gray(h=h, w=w, seed=h + w)
        got = cluster_kernel_model(img, 30.0, 60.0, ranks)
        want = K12.canny_fused_ref(_t(img)[None], 30.0, 60.0)[0].numpy()
        assert want.sum() > 30
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(canny_pallas(jnp.asarray(img, jnp.float32), 60.0, 30.0)))


class TestRouting:
    @pytest.mark.parametrize("h, w, route", [
        (480, 640, "fused"), (576, 1024, "fused"),
        (720, 1280, "cluster"), (1080, 1920, "cluster"), (2160, 3840, "cluster"),
        (2560, 3840, "cluster"),  # the tallest 3840-wide image 16 blocks hold
        (2561, 3840, "grid"),     # one row more: every block of the card
        (7713, 1280, "grid"), (2880, 5120, "grid"),
    ])
    def test_route_by_shape(self, h, w, route):
        assert K12.canny_route(h, w, H100_SMEM) == route

    def test_cluster_bytes(self):
        """3 masks of ceil(H / R) rows plus two halo rows a buffer, K1's
        tile over the second buffer where it is the larger."""
        assert K12.cluster_smem_bytes(720, 1280, 16) == 4 * 40 * (45 + 47) + 39376
        assert K12.cluster_smem_bytes(2160, 3840, 16) == 4 * 120 * (135 + 2 * 137)
        assert K12.fused_smem_bytes(576, 1024) == 230432 <= H100_SMEM


class TestWrapper:
    def test_cpu_takes_the_plain_version(self):
        img = np.stack([synthetic_gray(h=40, w=70, seed=s) for s in (3, 4)])
        before = (K12.canny_cluster.launches, K12.canny_fused.launches)
        for dtype in (np.uint8, np.float32):
            got = K12.canny_cluster(_t(img.astype(dtype)), 30.0, 60.0)
            assert torch.equal(got, K12.canny_fused_ref(_t(img), 30.0, 60.0))
        assert (K12.canny_cluster.launches, K12.canny_fused.launches) == before

    def test_other_devices_and_shapes_raise(self):
        with pytest.raises(ValueError, match="unsupported device"):
            K12.canny_cluster(torch.zeros(1, 6, 6, device="meta"), 1.0, 2.0)
        for shape in ((1, 1, 5), (1, 5, 1), (5, 5)):
            with pytest.raises(ValueError, match="REFLECT_101"):
                K12.canny_cluster(torch.zeros(shape), 100.0, 150.0)
