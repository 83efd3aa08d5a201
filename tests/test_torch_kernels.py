"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode on the CPU), and a numpy model of the fused
Canny kernel's tiles, ballots and packed words against the plain version.  The CUDA kernels
against the plain versions on the card are in test_torch_cuda.py, which
imports no jax so that it runs on a machine with the card.

Tolerances: bit-equal for K1 (cand/strong/edges) and K2 (reach); K3 sums
differ only in reduction order: rtol 1e-4 with atol 1e-5 of the largest
entry of each output (raw sums reach ~1e6).
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.ops.canny import canny as j_canny
from revo_tpu.ops.pallas.canny_kernel import canny_pallas
from revo_tpu.ops.pallas.hysteresis import hysteresis_pallas
from revo_tpu.ops.pallas.lgsx import lgsx_reduce as j_lgsx
from revo_tpu_torch.ops import canny as K12
from revo_tpu_torch.ops import lgsx as K3

from test_ops import synthetic_gray

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lgsx_inputs(seed, p=4096):
    rng = np.random.default_rng(seed)
    wxp = rng.normal(size=(p, 3)).astype(np.float32)
    wxp[:, 2] = np.abs(wxp[:, 2]) + 0.5
    wxp[::97, 2] = 0.0  # pz == 0 lanes take the 1e-12 guard
    grads = (rng.normal(size=(p, 2)) * 50).astype(np.float32)
    r = rng.uniform(0, 3, p).astype(np.float32)
    w = np.where(rng.random(p) < 0.8, np.minimum(1.0, 0.3 / r), 0.0).astype(np.float32)
    w[::97] = 0.0  # dead lanes
    return wxp, grads, r, w


def _assert_sums_close(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


class TestCannyPlain:
    @pytest.mark.parametrize("seed", [0, 5, 7])
    def test_matches_pallas_and_opencv(self, seed):
        img = synthetic_gray(h=120, w=160, seed=seed)
        got = K12.canny(_t(img.astype(np.float32)), 150.0, 100.0).numpy()
        want_cv = cv2.Canny(img, 150, 100, apertureSize=3, L2gradient=True) > 0
        want_pl = np.asarray(canny_pallas(jnp.asarray(img, jnp.float32), 150.0, 100.0))
        np.testing.assert_array_equal(got, want_cv)
        np.testing.assert_array_equal(got, want_pl)
        assert got.sum() > 100

    def test_batched_matches_single(self):
        imgs = np.stack([synthetic_gray(h=64, w=96, seed=s) for s in (1, 2, 3)])
        got = K12.canny_batched(_t(imgs.astype(np.float32)), 60.0, 30.0).numpy()
        for b in range(3):
            want = K12.canny(_t(imgs[b].astype(np.float32)), 60.0, 30.0).numpy()
            np.testing.assert_array_equal(got[b], want)

    def test_empty(self):
        assert not K12.canny(torch.zeros(64, 128)).any()


def ballot_words(mask: np.ndarray) -> np.ndarray:
    """An (H, W) mask as the fused kernel's warps store it: 32x32 tiles, one
    warp a tile row, lane j voting bit j and lanes past the right edge
    voting 0, the word stored at [y, tile column]; rows below the image
    store nothing."""
    h, w = mask.shape
    wpr = -(-w // 32)
    words = np.zeros((h, wpr), np.uint32)
    for ty in range(-(-h // 32)):
        for k in range(wpr):
            for row in range(32):  # a warp
                y = 32 * ty + row
                if y >= h:
                    continue
                votes = [bool(mask[y, 32 * k + j]) if 32 * k + j < w else False
                         for j in range(32)]
                words[y, k] = sum(1 << j for j, v in enumerate(votes) if v)
    return words


def words_fixpoint(c: np.ndarray, state: np.ndarray, h: int, w: int) -> np.ndarray:
    """K2's loop on packed words (H, ceil(W / 32)): horizontal dilation by
    shifts with carries from the neighbouring words, OR of three rows, trips
    of 8 synchronous steps, a step that grows nothing ends its trip, cap
    H + W; then the unpacking to (H, W) bool."""

    def dilate_rows(s):
        left, right = np.zeros_like(s), np.zeros_like(s)
        left[:, 1:] = s[:, :-1] >> 31
        right[:, :-1] = s[:, 1:] << 31
        return s | (s << 1) | (s >> 1) | left | right

    it, trip_grew = 0, True
    while trip_grew and it < h + w:
        trip_grew = False
        for _ in range(8):
            hd = dilate_rows(state)
            around = hd.copy()
            around[1:] |= hd[:-1]
            around[:-1] |= hd[1:]
            new = state | (c & around)
            grew = bool((new != state).any())
            state = new
            if not grew:
                break
            trip_grew = True
        it += 8
    bits = (state[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(h, -1)[:, :w].astype(bool)


def fused_kernel_model(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """What ``revo_canny_fused`` does to one (H, W) image, in numpy:
    REFLECT_101 on the index of the unpadded image (-1 -> 1, H -> H - 2),
    K1's classification, ``ballot_words``, ``words_fixpoint``."""
    h, w = gray.shape

    def reflect(v, n):
        return np.where(v < 0, -v, np.where(v >= n, 2 * n - 2 - v, v))

    ys, xs = reflect(np.arange(-1, h + 1), h), reflect(np.arange(-1, w + 1), w)
    padded = gray.astype(np.float32)[np.ix_(ys, xs)]
    cand, strong = (m[0].numpy() for m in K12.canny_nms_ref(
        torch.from_numpy(padded)[None], low * low, high * high))
    return words_fixpoint(ballot_words(cand), ballot_words(strong), h, w)


class TestCannyFused:
    @pytest.mark.parametrize("shape", [(120, 160), (29, 37)])
    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_plain_matches_pallas_jax_and_opencv(self, shape, dtype):
        """canny_fused on the CPU (its plain version) from unpadded uint8 or
        float32 gray, against the Pallas kernel, the XLA Canny and OpenCV."""
        h, w = shape
        imgs = np.stack([synthetic_gray(h=h, w=w, seed=s) for s in (2, 6)])
        got = K12.canny_fused(_t(imgs.astype(dtype)), 30.0, 60.0).numpy()
        assert got.dtype == bool and got.shape == imgs.shape and got.sum() > 30
        for b, img in enumerate(imgs):
            gray = jnp.asarray(img, jnp.float32)
            np.testing.assert_array_equal(got[b], np.asarray(canny_pallas(gray, 60.0, 30.0)))
            np.testing.assert_array_equal(got[b], np.asarray(j_canny(gray, 60.0, 30.0)))
            if shape == (120, 160):  # at 29x37 OpenCV itself leaves JAX by 8 pixels
                np.testing.assert_array_equal(
                    got[b], cv2.Canny(img, 60, 30, apertureSize=3, L2gradient=True) > 0)
        np.testing.assert_array_equal(
            got, K12.canny_batched(_t(imgs.astype(dtype)), 60.0, 30.0).numpy())

    @pytest.mark.parametrize("shape", [(29, 37), (40, 65), (33, 64)])
    def test_kernel_model_matches_plain(self, shape):
        """The kernel's data flow in numpy (index reflection, ballot words
        with zero overhang bits, word-wise fixpoint) gives the plain
        version's edges, ragged widths included."""
        img = synthetic_gray(h=shape[0], w=shape[1], seed=sum(shape))
        want = K12.canny_fused_ref(_t(img)[None], 30.0, 60.0)[0].numpy()
        assert want.sum() > 30
        np.testing.assert_array_equal(fused_kernel_model(img, 30.0, 60.0), want)

    def test_kernel_model_where_the_cap_binds(self):
        """A 1-px snake longer than H + W from one seed, on ragged rows: the
        word loop stops where the plain version's cap does.  (No gray image
        draws this snake through NMS, so the masks are packed directly, as
        the ballots would pack them.)"""
        h, w = 24, 70
        cand = np.zeros((h, w), bool)
        for y in range(0, h, 2):
            cand[y, 1:w - 1] = True
            if y + 1 < h:
                cand[y + 1, (w - 2) if (y // 2) % 2 == 0 else 1] = True
        strong = np.zeros_like(cand)
        strong[0, 1] = True
        want = K12.hysteresis_ref(_t(cand)[None], _t(strong)[None])[0].numpy()
        assert 0 < want.sum() < cand.sum()
        got = words_fixpoint(ballot_words(cand), ballot_words(strong), h, w)
        np.testing.assert_array_equal(got, want)

    def test_too_small_to_reflect_raises(self):
        for shape in ((1, 1, 5), (1, 5, 1), (5, 5)):
            with pytest.raises(ValueError, match="REFLECT_101"):
                K12.canny_fused(torch.zeros(shape), 100.0, 150.0)


class TestHysteresisPlain:
    @pytest.mark.parametrize("density", [0.05, 0.3, 0.6])
    def test_random_masks_match_pallas(self, density):
        rng = np.random.default_rng(int(density * 100))
        cand = rng.random((64, 128)) < density
        strong = cand & (rng.random((64, 128)) < 0.05)
        want = np.asarray(hysteresis_pallas(jnp.asarray(cand), jnp.asarray(strong)))
        got = K12.hysteresis_ref(_t(cand)[None], _t(strong)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)

    def test_serpentine_where_the_cap_binds(self):
        """A 1-px snake longer than H+W from one seed: the JAX fixpoint stops
        after H+W (rounded up to a trip of 8) dilation steps, before the
        snake is covered; the port must stop at the same pixel."""
        h, w = 24, 40
        cand = np.zeros((h, w), bool)
        for y in range(0, h, 2):
            cand[y, 1:w - 1] = True
            if y + 1 < h:
                cand[y + 1, (w - 2) if (y // 2) % 2 == 0 else 1] = True
        strong = np.zeros_like(cand)
        strong[0, 1] = True
        want = np.asarray(hysteresis_pallas(jnp.asarray(cand), jnp.asarray(strong)))
        got = K12.hysteresis_ref(_t(cand)[None], _t(strong)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < cand.sum()  # the cap bound: not all reached

    def test_batch_members_stop_independently(self):
        rng = np.random.default_rng(4)
        cand = rng.random((3, 32, 48)) < 0.4
        strong = cand & (rng.random((3, 32, 48)) < 0.02)
        strong[1] = False  # converges after one trip
        got = K12.hysteresis_ref(_t(cand), _t(strong)).numpy()
        for b in range(3):
            want = np.asarray(
                hysteresis_pallas(jnp.asarray(cand[b]), jnp.asarray(strong[b])))
            np.testing.assert_array_equal(got[b], want)


class TestLgsxPlain:
    @pytest.mark.parametrize("p", [4096, 3000])
    def test_matches_pallas(self, p):
        wxp, grads, r, w = _lgsx_inputs(p, p)
        want = j_lgsx(jnp.asarray(wxp), jnp.asarray(grads), jnp.asarray(r), jnp.asarray(w))
        got = K3.lgsx_reduce(_t(wxp), _t(grads), _t(r), _t(w))
        _assert_sums_close([x.numpy() for x in got], want)
        A = got[0].numpy()
        np.testing.assert_allclose(A, A.T, rtol=0, atol=1e-6 * np.abs(A).max())


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version(self):
        before = (K12.canny_nms.launches, K12.canny_hysteresis.launches,
                  K12.canny_fused.launches, K3.lgsx_reduce.launches)
        img = _t(synthetic_gray(h=32, w=48, seed=9).astype(np.float32))
        K12.canny(img)
        K3.lgsx_reduce(*(_t(x) for x in _lgsx_inputs(1, 64)))
        after = (K12.canny_nms.launches, K12.canny_hysteresis.launches,
                 K12.canny_fused.launches, K3.lgsx_reduce.launches)
        assert after == before  # no kernel launch on the CPU

    def test_other_devices_raise(self):
        m = torch.zeros(1, 4, 4, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError):
            K12.canny_hysteresis(m, m)
        with pytest.raises(ValueError):
            K12.canny_nms(torch.zeros(1, 6, 6, device="meta"), 1.0, 4.0)
        with pytest.raises(ValueError):
            K12.canny_fused(torch.zeros(1, 6, 6, device="meta"), 1.0, 2.0)
        x = torch.zeros(8, 3, device="meta")
        with pytest.raises(ValueError):
            K3.lgsx_reduce(x, x[:, :2], x[:, 0], x[:, 0])
