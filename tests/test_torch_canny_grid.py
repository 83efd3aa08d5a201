"""``canny_grid`` and K2's grid forms on the CPU: numpy models of the
cooperative kernels' data flow against the plain version and JAX's Pallas
kernels (interpret mode), the shape routing of ``canny_batched``, and the
wrappers' CPU contract.  The kernels themselves against their plain
versions on the card are in test_torch_cuda.py.

The models follow ``revo_canny_grid`` and ``revo_canny_hysteresis_grid``
(csrc/canny.cu, ``grid_fixpoint``): G blocks an image, block g owning rows
[g rb, min((g + 1) rb, H)) with rb = ceil(H / G), so the last blocks may own
none; B images in one grid.  With the state in shared memory, a block
publishes its band's first and last row to a "global" halo array at
parity 0 before the first barrier; each step it reads its neighbours' rows
of parity step & 1 into its halo rows, dilates, publishes its own edge rows
of the result at parity (step + 1) & 1, block (0, 0) resets slot
(step + 1) % 3, a block that grew ORs slot step % 3, and after the barrier
every block reads slot step % 3: one verdict for the whole grid, trips of
8, cap H + W.  With the state in global memory, every image's two state
buffers have a zero row above and below, and a band reads its neighbours'
rows where they lie.  Within a step the blocks run in a random order (the
card runs them in none), so a block that read what another wrote in the
same step, or a slot reset at the wrong step, would show.

Tolerance: bit-equal throughout (masks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu.ops.pallas.canny_kernel import canny_pallas
from revo_tpu.ops.pallas.hysteresis import hysteresis_pallas
from revo_tpu_torch.ops import canny as K12

from test_ops import synthetic_gray
from test_torch_canny_cluster import H100_SMEM, _dilate_rows, _unpack, bands, cluster_k1_words, snake
from test_torch_kernels import ballot_words

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _step_band(c, src_band, above, below):
    """One synchronous step of a band: (new rows, grew)."""
    hd = _dilate_rows(np.vstack([above, src_band, below]))
    new = src_band | (c & (hd[:-2] | hd[1:-1] | hd[2:]))
    return new, bool((new != src_band).any())


def grid_fixpoint_shared(cs, states, h, w, blocks, seed=0):
    """K2 of the grid kernel with each band in its block's shared memory, on
    B images' packed (H, ceil(W / 32)) words of cand and strong -> (B, H, W)
    bool.  The only way between blocks is the halo array and the slots."""
    rng = np.random.default_rng(seed)
    n_img, wpr = len(cs), cs[0].shape[1]
    spans = bands(h, blocks)
    zero = np.zeros((1, wpr), np.uint32)
    # Shared memory of block (b, g): its band of buffers 0 and 1.
    smem = {(b, g): [states[b][y0:y1].copy(), np.zeros((y1 - y0, wpr), np.uint32)]
            for b in range(n_img) for g, (y0, y1) in enumerate(spans)}
    halo = np.full((2, n_img, blocks, 2, wpr), 0xDEADBEEF, np.uint32)  # no content needed
    slots = np.full(3, 7, np.uint32)  # nor here: block (0, 0) resets slot 0
    for b in range(n_img):
        for g, (y0, y1) in enumerate(spans):
            if y1 > y0:
                halo[0, b, g, 0], halo[0, b, g, 1] = smem[b, g][0][0], smem[b, g][0][-1]
    slots[0] = 0
    # -- barrier --
    cur, step, it, trip_grew = 0, 0, 0, True
    order = list(smem)
    while trip_grew and it < h + w:
        trip_grew = False
        for _ in range(8):
            p = step & 1
            for b, g in (order[i] for i in rng.permutation(len(order))):
                y0, y1 = spans[g]
                if b == 0 and g == 0:
                    slots[(step + 1) % 3] = 0
                if y1 == y0:  # an empty band steps nothing, but passes the barrier
                    continue
                above = halo[p, b, g - 1, 1][None] if g > 0 else zero
                below = halo[p, b, g + 1, 0][None] if y1 < h else zero
                new, grew = _step_band(cs[b][y0:y1], smem[b, g][cur], above, below)
                smem[b, g][cur ^ 1] = new
                halo[p ^ 1, b, g, 0], halo[p ^ 1, b, g, 1] = new[0], new[-1]
                if grew:
                    slots[step % 3] |= 1
            # -- barrier --
            verdict = slots[step % 3] != 0
            step += 1
            cur ^= 1
            if not verdict:
                break
            trip_grew = True
        it += 8
    return np.stack([
        _unpack(np.vstack([smem[b, g][cur] for g in range(blocks)]), w) for b in range(n_img)])


def grid_fixpoint_global(cs, states, h, w, blocks, seed=0):
    """K2's grid form with the packed state in global memory: per image two
    buffers of H + 2 rows, rows 0 and H + 1 zero; block g steps buffer rows
    y0 + 1 .. y1 and reads rows y0 and y1 + 1 where they lie."""
    rng = np.random.default_rng(seed)
    n_img, wpr = len(cs), cs[0].shape[1]
    spans = bands(h, blocks)
    bufs = np.full((n_img, 2, h + 2, wpr), 0xDEADBEEF, np.uint32)
    for b in range(n_img):
        bufs[b, :, 0] = bufs[b, :, h + 1] = 0  # block 0 of each image
        bufs[b, 0, 1:h + 1] = states[b]  # each block its band
    slots = np.full(3, 7, np.uint32)
    slots[0] = 0
    cur, step, it, trip_grew = 0, 0, 0, True
    order = [(b, g) for b in range(n_img) for g in range(blocks)]
    while trip_grew and it < h + w:
        trip_grew = False
        for _ in range(8):
            for b, g in (order[i] for i in rng.permutation(len(order))):
                y0, y1 = spans[g]
                if b == 0 and g == 0:
                    slots[(step + 1) % 3] = 0
                if y1 == y0:
                    continue
                src = bufs[b, cur]
                new, grew = _step_band(cs[b][y0:y1], src[y0 + 1:y1 + 1], src[y0:y0 + 1],
                                       src[y1 + 1:y1 + 2])
                bufs[b, cur ^ 1, y0 + 1:y1 + 1] = new
                if grew:
                    slots[step % 3] |= 1
            verdict = slots[step % 3] != 0
            step += 1
            cur ^= 1
            if not verdict:
                break
            trip_grew = True
        it += 8
    return np.stack([_unpack(bufs[b, cur, 1:h + 1], w) for b in range(n_img)])


MODELS = {"grid": grid_fixpoint_shared, "grid_global": grid_fixpoint_global}


def _check(cands, strongs, blocks, form):
    """The model of ``form`` over B images in one grid against the plain
    version and JAX's Pallas K2 (vmap at B > 1: ``_run_batched``'s batched
    call), each image against itself alone."""
    h, w = cands[0].shape
    got = MODELS[form]([ballot_words(c) for c in cands], [ballot_words(s) for s in strongs],
                       h, w, blocks, seed=h * w + blocks)
    want = K12.hysteresis_ref(_t(np.stack(cands)), _t(np.stack(strongs))).numpy()
    np.testing.assert_array_equal(got, want)
    c_j, s_j = jnp.asarray(np.stack(cands)), jnp.asarray(np.stack(strongs))
    pallas = hysteresis_pallas(c_j[0], s_j[0])[None] if len(cands) == 1 else \
        jax.vmap(hysteresis_pallas)(c_j, s_j)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    return got


def _random_masks(h, w, seed):
    rng = np.random.default_rng(seed)
    cand = rng.random((h, w)) < 0.45
    return cand, cand & (rng.random((h, w)) < 0.03)


SHAPES = [
    (40, 65, 1),     # one block: the one-block fixpoint; ragged rows
    (33, 64, 2),     # bands of 17 and 16 rows
    (50, 37, 8),     # bands of 7, the last of 1 row; ragged
    (29, 70, 29),    # 1-row bands
    (20, 96, 32),    # G > H: blocks 20-31 empty
    (29, 70, 16),    # bands of 2, block 14 one row, block 15 empty
    (64, 100, 132),  # an H100's G at B = 1: 1-row bands, 68 empty
]


class TestGridModel:
    @pytest.mark.parametrize("form", sorted(MODELS))
    @pytest.mark.parametrize("h, w, blocks", SHAPES)
    def test_random_masks_match_plain_and_pallas(self, h, w, blocks, form):
        cand, strong = _random_masks(h, w, h * w + blocks)
        got = _check([cand], [strong], blocks, form)[0]
        assert strong.sum() < got.sum() < cand.sum()  # it grew, and not everywhere

    @pytest.mark.parametrize("form", sorted(MODELS))
    @pytest.mark.parametrize("blocks", [2, 8, 12, 30])
    def test_snake_across_bands_where_the_cap_binds(self, blocks, form):
        """The snake's rows cross every band boundary (bands of 12, 3, 2 and
        1 rows; at 30 blocks the last six are empty): the grid stops at the
        pixel where the JAX loop's cap stops."""
        cand, strong = snake(24, 70)
        got = _check([cand], [strong], blocks, form)[0]
        assert 0 < got.sum() < cand.sum()

    @pytest.mark.parametrize("form", sorted(MODELS))
    @pytest.mark.parametrize("blocks", [1, 5, 24])
    def test_one_verdict_for_a_batch(self, blocks, form):
        """Three images in one grid, one of them a snake the cap stops and
        one that stops growing after a trip: every block follows the one
        verdict, and each image is still its own fixpoint (JAX's batched
        call, where each image stops on its own)."""
        c0, s0 = snake(24, 70)
        c1, s1 = _random_masks(24, 70, 5)
        c2, s2 = np.zeros((24, 70), bool), np.zeros((24, 70), bool)
        c2[10, 5:9] = s2[10, 5] = True
        got = _check([c0, c1, c2], [s0, s1, s2], blocks, form)
        assert 0 < got[0].sum() < c0.sum() and got[2].sum() == 4

    @pytest.mark.parametrize("h, w, blocks", [(120, 160, 16), (61, 300, 44), (37, 53, 40),
                                              (66, 130, 132)])
    def test_kernel_model_from_gray(self, h, w, blocks):
        """canny_grid: K1 in band tiles (every band word stored once) and the
        grid fixpoint with its bands in shared memory give the plain
        version's edges and the Pallas Canny's."""
        img = synthetic_gray(h=h, w=w, seed=h + w)
        cand, strong = (m[0].numpy() for m in K12.canny_nms_ref(
            K12._reflect_pad(_t(img).float()[None], 1, 1), 900.0, 3600.0))
        words = cluster_k1_words(cand, strong, blocks)
        got = grid_fixpoint_shared([words[0]], [words[1]], h, w, blocks)[0]
        want = K12.canny_fused_ref(_t(img)[None], 30.0, 60.0)[0].numpy()
        assert want.sum() > 30
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(canny_pallas(jnp.asarray(img, jnp.float32), 60.0, 30.0)))


class TestRouting:
    @pytest.mark.parametrize("h, w, route", [
        (480, 640, "fused"), (576, 1024, "fused"),
        (720, 1280, "cluster"), (2560, 3840, "cluster"),
        (2561, 3840, "grid"),     # one row above the cluster
        (3000, 4000, "grid"),     # 12 MP
        (2880, 5120, "grid"), (4320, 7680, "grid"),
        (15708, 5120, "grid"),    # the tallest 5120-wide image 132 blocks hold
        (15709, 5120, "split"),   # one row more
        (8192, 12288, "split"),   # ~101 Mpx
    ])
    def test_route_by_shape(self, h, w, route):
        assert K12.canny_route(h, w, H100_SMEM) == route

    def test_route_follows_the_resident_blocks(self):
        """Fewer blocks held at once, larger bands: 5120x2880 needs more than
        a block's memory with 16 blocks, not with 32."""
        assert K12.canny_route(2880, 5120, H100_SMEM, resident=16) == "split"
        assert K12.canny_route(2880, 5120, H100_SMEM, resident=32) == "grid"

    def test_grid_band_bytes(self):
        """The cluster kernel's band (cand, two buffers with their halo rows,
        K1's tile over the second where it is larger) over G blocks; K2's
        grid form has no tile."""
        assert K12.cluster_smem_bytes(2880, 5120, 132) == 4 * 160 * 22 + 4 * 160 * 24 + 39376
        assert K12.cluster_smem_bytes(4320, 7680, 132) == 104656
        assert K12.band_smem_bytes(4320, 7680, 132) == 4 * 240 * (33 + 2 * 35)
        assert K12.band_smem_bytes(8192, 12288, 132) == 296448 > H100_SMEM

    @pytest.mark.parametrize("b, blocks", [(1, 132), (2, 66), (3, 44), (5, 26), (6, 0),
                                           (133, 0)])
    def test_grid_blocks_split_over_images(self, b, blocks):
        """B images share the card's blocks: G = 132 // B, while the band of
        5120x2880 fits (up to 5 images a launch: 22 blocks an image would
        need 254080 bytes a block)."""
        assert K12.grid_blocks(2880, 5120, b, H100_SMEM) == blocks

    def test_grid_blocks_zero_where_the_band_does_not_fit(self):
        assert K12.grid_blocks(8192, 12288, 1, H100_SMEM) == 0
        assert K12.grid_blocks(4320, 7680, 2, H100_SMEM) == 66
        assert K12.grid_blocks(4320, 7680, 12, H100_SMEM) == 0  # bands of 393 rows


class TestWrapper:
    def test_cpu_takes_the_plain_version(self):
        img = np.stack([synthetic_gray(h=40, w=70, seed=s) for s in (3, 4)])
        before = (K12.canny_grid.launches, K12.canny_fused.launches)
        for dtype in (np.uint8, np.float32):
            got = K12.canny_grid(_t(img.astype(dtype)), 30.0, 60.0)
            assert torch.equal(got, K12.canny_fused_ref(_t(img), 30.0, 60.0))
            assert torch.equal(K12.canny_grid(_t(img.astype(dtype)), 30.0, 60.0, _blocks=3), got)
        assert (K12.canny_grid.launches, K12.canny_fused.launches) == before

    @pytest.mark.parametrize("form", K12.K2_FORMS)
    def test_k2_forms_on_the_cpu_take_the_plain_version(self, form):
        cand, strong = (_t(m)[None] for m in snake(24, 70))
        before = K12.canny_hysteresis.launches
        got = K12.canny_hysteresis(cand, strong, _form=form, _blocks=5)
        assert torch.equal(got, K12.hysteresis_ref(cand, strong))
        assert K12.canny_hysteresis.launches == before

    def test_other_devices_and_shapes_raise(self):
        with pytest.raises(ValueError, match="unsupported device"):
            K12.canny_grid(torch.zeros(1, 6, 6, device="meta"), 1.0, 2.0)
        with pytest.raises(ValueError, match="unsupported device"):
            K12.canny_hysteresis(torch.zeros(1, 6, 6, dtype=torch.bool, device="meta"),
                                 torch.zeros(1, 6, 6, dtype=torch.bool, device="meta"),
                                 _form="grid")
        for shape in ((1, 1, 5), (1, 5, 1), (5, 5)):
            with pytest.raises(ValueError, match="REFLECT_101"):
                K12.canny_grid(torch.zeros(shape), 100.0, 150.0)
