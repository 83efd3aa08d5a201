"""The port's three kernels: plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU).  The CUDA kernels
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
                  K3.lgsx_reduce.launches)
        img = _t(synthetic_gray(h=32, w=48, seed=9).astype(np.float32))
        K12.canny(img)
        K3.lgsx_reduce(*(_t(x) for x in _lgsx_inputs(1, 64)))
        after = (K12.canny_nms.launches, K12.canny_hysteresis.launches,
                 K3.lgsx_reduce.launches)
        assert after == before  # no kernel launch on the CPU

    def test_other_devices_raise(self):
        m = torch.zeros(1, 4, 4, dtype=torch.bool, device="meta")
        with pytest.raises(ValueError):
            K12.canny_hysteresis(m, m)
        with pytest.raises(ValueError):
            K12.canny_nms(torch.zeros(1, 6, 6, device="meta"), 1.0, 4.0)
        x = torch.zeros(8, 3, device="meta")
        with pytest.raises(ValueError):
            K3.lgsx_reduce(x, x[:, :2], x[:, 0], x[:, 0])
