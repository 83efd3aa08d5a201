"""``canny_fused`` on the CPU: a numpy model of the kernel's data flow
(tests/_torch_fused_model.py) against the plain version and JAX's Pallas
kernels (interpret mode), and the wrapper's CPU contract.  The kernel
itself against its plain version on the card is in test_torch_cuda.py.

The model follows ``canny_fused_kernel`` (csrc/canny.cu): K1 by the warps
of P blocks an image over strips of 32 columns by 8 rows (every word
stored once, whatever P), then K2's synchronous steps on the frontier: two
buffers that start as strong, dirty bits a word, a step evaluating only the
words around the words that changed at the step before, trips of 8, a
step that grows nothing ends its trip, cap H + W.  Inside the model every
step asserts that each word it leaves out holds the same value in both
buffers and would not have changed.

Tolerance: bit-equal throughout (masks).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.ops.pallas.canny_kernel import canny_pallas
from revo_tpu.ops.pallas.hysteresis import hysteresis_pallas
from revo_tpu_torch.ops import canny as K12

from _torch_fused_model import (classify_strip, frontier_fixpoint, fused_blocks,
                                fused_kernel_model, k1_words, pack, strip_owners)
from test_ops import synthetic_gray
from test_torch_canny_cluster import snake

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import serpentine_gray  # noqa: E402

torch.set_num_threads(1)

H100_SMEM = 232448  # opt-in shared memory of one H100 block


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(mask: np.ndarray) -> np.ndarray:
    return pack(mask, -(-mask.shape[1] // 32))


def _check_masks(cand, strong):
    """The frontier fixpoint on packed masks against the plain version and
    JAX's Pallas K2; returns (edges, steps, largest frontier, evaluated)."""
    h, w = cand.shape
    got, steps, most, total = frontier_fixpoint(_words(cand), _words(strong), h, w)
    want = K12.hysteresis_ref(_t(cand)[None], _t(strong)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(hysteresis_pallas(jnp.asarray(cand), jnp.asarray(strong))))
    return got, steps, most, total


class TestFrontierFixpoint:
    @pytest.mark.parametrize("h, w", [(40, 65), (29, 37), (64, 128), (3, 1100)])
    def test_random_masks_match_plain_and_pallas(self, h, w):
        """Dense random masks grow in many places at once; 3x1100 has two
        dirty words a row (36 words), so the frontier carries across them."""
        rng = np.random.default_rng(h * w)
        cand = rng.random((h, w)) < 0.45
        strong = cand & (rng.random((h, w)) < 0.03)
        got = _check_masks(cand, strong)[0]
        assert strong.sum() < got.sum() < cand.sum()

    def test_snake_where_the_cap_binds(self):
        """A 1-px snake longer than H + W from one seed, on ragged rows: the
        frontier is the snake's head, one step after another, and the loop
        stops at the pixel where the JAX loop's cap stops."""
        cand, strong = snake(24, 70)
        got, steps, most, _ = _check_masks(cand, strong)
        assert 0 < got.sum() < cand.sum()
        assert steps == 24 + 70 + (-(24 + 70)) % 8  # every trip ran to its end
        assert most <= 6  # a head's 3x3 words, and the words it left

    def test_growth_across_words_and_rows(self):
        """Chains that cross word boundaries (columns 31 | 32 and 63 | 64),
        run down a word boundary, and step diagonally from row to row, grown
        from one seed each; and a chain with no seed, which stays out."""
        h, w = 48, 100
        cand = np.zeros((h, w), bool)
        cand[5, 20:80] = True                       # across two word boundaries
        cand[5:40, 31] = cand[5:40, 32] = True      # down a word boundary
        for i in range(30):                          # a diagonal across rows and words
            cand[10 + i, 50 + i] = True
        cand[44, 2:98] = True                        # no seed on it
        strong = np.zeros_like(cand)
        strong[5, 79] = True
        strong[10, 50] = True
        got = _check_masks(cand, strong)[0]
        assert got[5, 20] and got[39, 31] and got[39, 32] and got[39, 79]
        assert not got[44].any()

    def test_nothing_to_grow(self):
        """No strong pixel: one trip whose first step evaluates nothing."""
        cand = np.ones((16, 40), bool)
        got, steps, most, total = _check_masks(cand, np.zeros_like(cand))
        assert not got.any() and (steps, most, total) == (1, 0, 0)

    @pytest.mark.parametrize("shape", [(48, 64), (47, 41), (120, 200)])
    def test_gray_serpentine_where_the_cap_binds(self, shape):
        """chip_smoke's gray serpentines (phase 4's cases): the whole kernel
        model stops where the plain version's cap stops, and the frontier
        is a small part of the image at every step."""
        img = serpentine_gray(*shape)
        got, steps, most, total = fused_kernel_model(img, 40.0, 150.0)
        want = K12.canny_fused_ref(_t(img)[None], 40.0, 150.0)[0].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(canny_pallas(jnp.asarray(img, jnp.float32), 150.0, 40.0)))
        cand = K12.canny_nms_ref(K12._reflect_pad(_t(img)[None].float(), 1, 1),
                                 1600.0, 22500.0)[0].numpy()
        assert 0 < want.sum() < cand.sum()
        h, w = shape
        assert steps >= h + w
        assert total < steps * h * -(-w // 32) / 4


class TestKernelModel:
    @pytest.mark.parametrize("h, w, blocks", [(120, 160, 75), (120, 160, 7), (29, 37, 1),
                                              (40, 65, 15), (61, 100, 4)])
    def test_from_gray_matches_plain_and_pallas(self, h, w, blocks):
        """K1 in strips (each word stored by one warp of one block, ragged
        rows and bands included) and the frontier fixpoint give the plain
        version's edges and the Pallas Canny's."""
        img = synthetic_gray(h=h, w=w, seed=h + w)
        got = fused_kernel_model(img, 30.0, 60.0, blocks)[0]
        want = K12.canny_fused_ref(_t(img)[None], 30.0, 60.0)[0].numpy()
        assert want.sum() > 30
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(canny_pallas(jnp.asarray(img, jnp.float32), 60.0, 30.0)))

    def test_strip_words_are_the_plain_ballots(self):
        """Each strip's words, the outer columns taken from lanes 0, 1, 30
        and 31, equal the plain K1's masks packed 32 pixels a word, at the
        image's corners and at a ragged right edge."""
        img = synthetic_gray(h=37, w=70, seed=5)
        pad = K12._reflect_pad(_t(img)[None].float(), 1, 1)
        cand, strong = (m[0].numpy() for m in K12.canny_nms_ref(pad, 900.0, 3600.0))
        c_w, s_w = _words(cand), _words(strong)
        for x0, y0 in ((0, 0), (64, 0), (32, 32), (64, 32)):
            for y, (cb, sb) in classify_strip(img, x0, y0, 900.0, 3600.0).items():
                assert (cb, sb) == (c_w[y, x0 // 32], s_w[y, x0 // 32]), (x0, y)
        c_all, s_all = k1_words(img, 900.0, 3600.0, 3)
        np.testing.assert_array_equal(c_all, c_w)
        np.testing.assert_array_equal(s_all, s_w)

    def test_batch_of_eight(self):
        """B = 8 images in one launch: P = 132 // 8 blocks each, every image
        its own fixpoint and its own stop; against the plain version of the
        batch and JAX's batched K2 (the grid-over-batch Pallas kernel)."""
        imgs = np.stack([synthetic_gray(h=40, w=65, seed=s) for s in range(8)])
        blocks = fused_blocks(8, 40, 65)
        assert blocks == 15 and len({s for _, _, s in strip_owners(40, 65, blocks)}) == 15
        got = np.stack([fused_kernel_model(img, 30.0, 60.0, blocks)[0] for img in imgs])
        np.testing.assert_array_equal(got, K12.canny_fused_ref(_t(imgs), 30.0, 60.0).numpy())
        pad = K12._reflect_pad(_t(imgs).float(), 1, 1)
        cand, strong = (m.numpy() for m in K12.canny_nms_ref(pad, 900.0, 3600.0))
        np.testing.assert_array_equal(
            got, np.asarray(jax.vmap(hysteresis_pallas)(jnp.asarray(cand), jnp.asarray(strong))))

    @pytest.mark.parametrize("b, h, w, blocks", [(1, 480, 640, 132), (8, 480, 640, 16),
                                                 (1, 120, 160, 75), (8, 120, 160, 16),
                                                 (200, 240, 320, 1)])
    def test_blocks_an_image(self, b, h, w, blocks):
        """P: the card's 132 resident blocks shared by the images, at most
        one a strip, at least one; every strip has one owner."""
        assert fused_blocks(b, h, w) == blocks
        owners = strip_owners(h, w, blocks)
        assert sorted(s for _, _, s in owners) == list(range(-(-w // 32) * -(-h // 8)))


class TestWrapper:
    def test_shared_memory_and_route(self):
        """The fixpoint's bytes (flags, three masks, four masks of a bit a
        word; the launch adds the list): up to 1024x576 on canny_fused,
        1280x720 not."""
        assert K12.fused_smem_bytes(480, 640) == 4 * (8 + 3 * 9600 + 4 * 480)
        assert K12.fused_smem_bytes(576, 1024) == 230432 <= H100_SMEM
        assert K12.fused_smem_bytes(3, 1100) == 4 * (8 + 3 * 108 + 4 * 3 * 2)
        assert K12.canny_route(576, 1024, H100_SMEM) == "fused"
        assert K12.canny_route(720, 1280, H100_SMEM) == "cluster"

    def test_cpu_takes_the_plain_version(self):
        img = np.stack([synthetic_gray(h=40, w=70, seed=s) for s in (3, 4)])
        before = K12.canny_fused.launches
        want = K12.canny_fused_ref(_t(img), 30.0, 60.0)
        for dtype in (np.uint8, np.float32):
            for form in K12.FUSED_FORMS:
                got = K12.canny_fused(_t(img.astype(dtype)), 30.0, 60.0, _form=form)
                assert torch.equal(got, want)
        assert K12.canny_fused.launches == before

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="unsupported device"):
            K12.canny_fused(torch.zeros(1, 6, 6, device="meta"), 1.0, 2.0)
