"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no jax, so it runs where the
card is:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: bit-equal for K1/K2 masks (K2 in all its forms), the fused,
the cluster and the grid Canny's edges and the front end's edges/clouds; K3 within rtol 1e-4 / atol 1e-5 of each output's
largest entry (reduction order), and bit-identical from run to run (fixed
order, no atomics); fused K3, in each of its table layouts: good and bad
counts equal, floats within 1e-5 of each output's largest entry,
bit-identical from run to run, and over 8 lanes each lane bit-equal to its
one-lane launch; a batched track on the
card: each lane bit-equal to the lane tracked alone; VOSystem on
the card: the CPU run's per-frame flags, poses within 1e-4; loop closure on
the card: the CPU's verdicts, corrected poses within 1e-4; a run resumed on
the card from a checkpoint or a saved scan state: the continuous run's
poses bit for bit; windowed BA on the card: within 1e-3 m / 1e-3 rad of the
CPU's on the same keyframes (its block sums are atomic adds, and the LM
schedule may part on a tie), the windowed system itself within 1e-4 of its
largest entry; undistortion on the card: the rectified frame equal to the
CPU's, VOSystem flags equal and poses within 1e-4; segments on the card: the
CPU's stitched poses within 5e-4.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from revo_tpu_torch import frontend, kernels, lanes, solver
from revo_tpu_torch.config import CameraConfig, SystemConfig
from revo_tpu_torch.io.synthetic import SyntheticScene, render_frame
from revo_tpu_torch.ops import canny as K12
from revo_tpu_torch.ops import lgsx as K3
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.ops.filters import _reflect_pad

from _torch_fused_model import frontier_fixpoint, pack
from _torch_inputs import BF16_FORMS, CAM, TABLE_FORMS, make_inputs, make_pose, torch_args

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import serpentine_gray  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.device("cuda")


def _gray(h, w, seed):
    """Smooth blobs plus a bright rectangle, uint8-valued float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 40.0 + 30.0 * np.sin(xx / 17.0) + 25.0 * np.cos(yy / 23.0)
    for _ in range(8):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s, a = rng.uniform(5, 25), rng.uniform(40, 120)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img[int(h * 0.3):int(h * 0.6), int(w * 0.2):int(w * 0.5)] += 60
    return np.round(np.clip(img, 0, 255)).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 480, 640), (8, 120, 160), (3, 37, 53)])
def test_canny_kernels_bit_equal(cuda, shape):
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda)
    gp = _reflect_pad(imgs, 1, 1).contiguous()
    c_p, s_p = K12.canny_nms_ref(gp, 1e4, 2.25e4)
    for g in (imgs, imgs.to(torch.uint8)):
        c_k, s_k = K12.canny_nms(g, 1e4, 2.25e4)
        assert torch.equal(c_k, c_p) and torch.equal(s_k, s_p)
    want = K12.hysteresis_ref(c_p, s_p)
    assert K12.hysteresis_fits_shared(cuda, h, w)
    for form in (None, *K12.K2_FORMS):
        assert torch.equal(K12.canny_hysteresis(c_p, s_p, _form=form), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(1, 480, 640), (3, 37, 53), (2, 1027, 2051), (1, 2160, 3840)])
def test_canny_nms_unpadded_bit_equal(cuda, shape, dtype):
    """K1 from unpadded gray, uint8 and float32: whole-chunk rows (vector
    reads, 16-byte stores), ragged rows (scalar reads, byte stores), tiles
    that are all border, and 3840x2160, whose 4,050 tiles are more than one
    wave of the persistent blocks: bit-equal to the plain version on the
    padded float32 copy, and the same bits from a second launch."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda, dtype)
    c_p, s_p = K12.canny_nms_ref(_reflect_pad(imgs.float(), 1, 1), 1e4, 2.25e4)
    assert int(c_p.sum()) > 0
    blocks = K12._nms_blocks(cuda, b, h, w, int(dtype == torch.uint8))
    assert 1 <= blocks <= K12.nms_tiles(b, h, w)
    if h > 1000:
        assert blocks < K12.nms_tiles(b, h, w)
    before = K12.canny_nms.launches
    c_k, s_k = K12.canny_nms(imgs, 1e4, 2.25e4)
    assert K12.canny_nms.launches == before + 1
    assert torch.equal(c_k, c_p) and torch.equal(s_k, s_p)
    again = K12.canny_nms(imgs, 1e4, 2.25e4)
    assert torch.equal(again[0], c_k) and torch.equal(again[1], s_k)


def test_canny_nms_unaligned_gray_and_refusals(cuda):
    """A uint8 view that starts one byte into its storage takes the scalar
    reads, bit-equal; the kernel's tile is the wrapper's NMS_TILE; H or W
    below 2 raises, and a launch of 0 blocks raises with its status."""
    flat = torch.from_numpy(_gray(64, 640, 0)).to(cuda, torch.uint8).reshape(-1)
    g = torch.cat([flat.new_zeros(1), flat])[1:].view(1, 64, 640)
    assert g.data_ptr() % 16 == 1
    c_p, s_p = K12.canny_nms_ref(_reflect_pad(g.float(), 1, 1), 1e4, 2.25e4)
    c_k, s_k = K12.canny_nms(g, 1e4, 2.25e4)
    assert torch.equal(c_k, c_p) and torch.equal(s_k, s_p)
    tile = kernels.call("revo_canny_nms_tile", device=cuda)
    assert (tile >> 16, tile & 0xFFFF) == K12.NMS_TILE
    with pytest.raises(ValueError):
        K12.canny_nms(torch.zeros((1, 1, 64), dtype=torch.uint8, device=cuda), 1.0, 4.0)
    with pytest.raises(RuntimeError, match="status"):
        kernels.launch("revo_canny_nms", g, 1, c_k, s_k, 1, 64, 640, 1e4, 2.25e4, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(1, 480, 640), (8, 480, 640), (8, 240, 320), (8, 120, 160),
                                   (3, 37, 53), (2, 29, 65), (1, 576, 1024), (2, 3, 1100),
                                   (2, 2, 2)])
def test_canny_fused_bit_equal(cuda, shape, dtype):
    """One launch from unpadded gray, float32 or uint8, whole-word and
    ragged rows, a row of two dirty words (1100 wide), up to the largest
    image the shared-memory fixpoint takes, B = 8 at every pyramid level
    of a 640x480 frame: the plain version's edges, the same bits from a
    second launch and from the dense form; each image's steps, largest
    frontier and words evaluated are the numpy model's."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda, dtype)
    before = (K12.canny_fused.launches, K12.canny_nms.launches, K12.canny_hysteresis.launches)
    got = K12.canny_batched(imgs, 60.0, 30.0)
    assert (K12.canny_fused.launches, K12.canny_nms.launches,
            K12.canny_hysteresis.launches) == (before[0] + 1, before[1], before[2])
    want = K12.canny_fused_ref(imgs, 30.0, 60.0)
    assert got.dtype == torch.bool and torch.equal(got, want)
    stats = torch.full((b, 9), -1, dtype=torch.int64, device=cuda)
    assert torch.equal(K12.canny_fused(imgs, 30.0, 60.0, _stats=stats), want)
    assert torch.equal(K12.canny_fused(imgs, 30.0, 60.0, _form="dense"), want)
    c_p, s_p = K12.canny_nms_ref(_reflect_pad(imgs.float(), 1, 1), 900.0, 3600.0)
    for i in range(b):
        model = frontier_fixpoint(pack(c_p[i].cpu().numpy(), -(-w // 32)),
                                  pack(s_p[i].cpu().numpy(), -(-w // 32)), h, w)
        np.testing.assert_array_equal(model[0], want[i].cpu().numpy())
        assert tuple(stats[i, :3].tolist()) == model[1:], i
        t = stats[i, 3:8].tolist()  # start, ticket, steps begin, steps end, end
        assert t == sorted(t) and t[0] > 0, i
    if h > 2:
        assert int(want.sum()) > 0


@pytest.mark.parametrize("shape", [(48, 64), (47, 41), (120, 200)])
def test_canny_fused_cap_binds_on_card(cuda, shape):
    """A gray serpentine whose weak contour is longer than H+W from one
    strong stretch: both forms of the fused kernel stop where the plain
    loop's cap stops."""
    g = torch.from_numpy(serpentine_gray(*shape))[None].to(cuda)
    want = K12.canny_fused_ref(g, 40.0, 150.0)
    cand = K12.canny_nms_ref(_reflect_pad(g.float(), 1, 1), 1600.0, 22500.0)[0]
    assert 0 < int(want.sum()) < int(cand.sum())
    for form in K12.FUSED_FORMS:
        assert torch.equal(K12.canny_fused(g, 40.0, 150.0, _form=form), want)
        assert torch.equal(K12.canny_fused(g.float(), 40.0, 150.0, _form=form), want)


def test_canny_fused_list_overflow_steps_every_word(cuda):
    """At 1024x576 a warp's list of frontier words has room for about 67
    words; a noise image's frontier is larger, so those warps step every
    word of their rows: the same bits, and the numpy model's step counts."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.integers(0, 256, (1, 576, 1024), dtype=np.uint8)).to(cuda)
    want = K12.canny_fused_ref(g, 30.0, 60.0)
    stats = torch.zeros((1, 9), dtype=torch.int64, device=cuda)
    assert torch.equal(K12.canny_fused(g, 30.0, 60.0, _stats=stats), want)
    c_p, s_p = K12.canny_nms_ref(_reflect_pad(g.float(), 1, 1), 900.0, 3600.0)
    model = frontier_fixpoint(pack(c_p[0].cpu().numpy(), 32), pack(s_p[0].cpu().numpy(), 32),
                              576, 1024)
    assert tuple(stats[0, :3].tolist()) == model[1:]
    assert int(stats[0, 8]) >= 1


def test_canny_fused_probe_and_refusals(cuda):
    """With its cap set to 0 the kernel runs K1, the masks' round trip and
    the unpacking alone, so the edges are the strong pixels; a form it does
    not know and a stats tensor of the wrong shape raise."""
    imgs = torch.from_numpy(np.stack([_gray(120, 160, s) for s in range(2)])).to(cuda)
    strong = K12.canny_nms_ref(_reflect_pad(imgs, 1, 1), 900.0, 3600.0)[1]
    stats = torch.zeros((2, 9), dtype=torch.int64, device=cuda)
    assert torch.equal(K12.canny_fused(imgs, 30.0, 60.0, _max_iters=0, _stats=stats), strong)
    assert stats[:, :3].tolist() == [[0, 0, 0], [0, 0, 0]]
    assert 1 <= K12._fused_blocks(cuda, 2, 120, 160) <= 75
    with pytest.raises(ValueError, match="form"):
        K12.canny_fused(imgs, 30.0, 60.0, _form="tiles")
    with pytest.raises(ValueError, match="stats"):
        K12.canny_fused(imgs, 30.0, 60.0, _stats=stats[:1])


def _canny_counts():
    return (K12.canny_fused.launches, K12.canny_cluster.launches, K12.canny_nms.launches,
            K12.canny_hysteresis.launches, K12.canny_grid.launches)


def test_canny_large_image_takes_the_split_kernels(cuda):
    """An image whose packed masks exceed a cluster's shared memory
    (5120x2880), which took the split kernels before the grid kernel:
    chosen by shape before any launch, canny_batched runs one canny_grid
    launch and neither canny_nms nor canny_hysteresis, and canny_fused and
    canny_cluster refuse it.  The split kernels' own case is
    test_canny_above_the_grid_takes_the_split_kernels."""
    h, w = 2880, 5120
    assert K12.canny_route(h, w, K12._shared_limit(cuda)) == "grid"
    g = torch.from_numpy(_gray(h, w, 3))[None].to(cuda)
    before = _canny_counts()
    got = K12.canny_batched(g, 150.0, 100.0)
    assert _canny_counts() == (*before[:4], before[4] + 1)
    assert torch.equal(got, K12.canny_fused_ref(g, 100.0, 150.0))
    with pytest.raises(ValueError, match="shared memory"):
        K12.canny_fused(g, 100.0, 150.0)
    with pytest.raises(ValueError, match="cluster"):
        K12.canny_cluster(g, 100.0, 150.0)


def test_canny_above_the_grid_takes_the_split_kernels(cuda):
    """An image above the shared memory of every block the card holds at
    once (12288x8192, ~101 Mpx): canny_batched runs canny_nms and one
    launch of K2's grid form with its state in global memory, and
    canny_grid refuses it."""
    h, w = 8192, 12288
    assert K12.canny_route(h, w, K12._shared_limit(cuda)) == "split"
    assert not K12.canny_fits_grid(cuda, h, w)
    g = torch.from_numpy(np.tile(_gray(1024, 1536, 4), (8, 8)))[None].to(cuda, torch.uint8)
    before = _canny_counts()
    got = K12.canny_batched(g, 150.0, 100.0)
    assert _canny_counts() == (before[0], before[1], before[2] + 1, before[3] + 1, before[4])
    assert torch.equal(got, K12.canny_fused_ref(g, 100.0, 150.0))
    with pytest.raises(ValueError, match="do not fit"):
        K12.canny_grid(g, 100.0, 150.0)


def test_canny_1280x720_takes_the_cluster_kernel(cuda):
    """A 1280x720 image, above one block's shared memory: canny_batched
    runs one canny_cluster launch of 16 blocks and nothing else."""
    g = torch.from_numpy(_gray(720, 1280, 3))[None].to(cuda)
    assert not K12.hysteresis_fits_shared(cuda, 720, 1280)
    assert K12.hysteresis_fits_cluster(cuda, 720, 1280) and K12._cluster_ranks(cuda, 720, 1280) == 16
    before = _canny_counts()
    got = K12.canny_batched(g, 150.0, 100.0)
    assert _canny_counts() == (before[0], before[1] + 1, *before[2:])
    assert torch.equal(got, K12.canny_fused_ref(g, 100.0, 150.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(1, 720, 1280), (3, 720, 1280), (1, 1080, 1920),
                                   (3, 1080, 1920), (1, 1440, 2560)])
def test_canny_cluster_bit_equal(cuda, shape, dtype):
    """One cluster launch from unpadded gray, float32 or uint8, at the card's
    cluster size and at 8 and 16 blocks an image: the plain version's
    edges, and the same bits from a second launch."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda, dtype)
    want = K12.canny_fused_ref(imgs, 30.0, 60.0)
    assert int(want.sum()) > 0
    for ranks in (None, 8, 16):
        got = K12.canny_cluster(imgs, 30.0, 60.0, _ranks=ranks)
        assert got.dtype == torch.bool and torch.equal(got, want)
        assert torch.equal(K12.canny_cluster(imgs, 30.0, 60.0, _ranks=ranks), got)


@pytest.mark.parametrize("shape, ranks", [((2, 29, 70), 16), ((1, 50, 37), 8), ((1, 40, 65), 1),
                                          ((3, 33, 64), 2), ((1, 721, 1283), 16), ((2, 2, 2), 4)])
def test_canny_cluster_bands_ragged_and_empty(cuda, shape, ranks):
    """Bands that do not divide H, ranks whose band is empty, rows that end
    inside a word, one rank alone: the plain version's edges."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda)
    for g in (imgs, imgs.to(torch.uint8)):
        assert torch.equal(K12.canny_cluster(g, 30.0, 60.0, _ranks=ranks),
                           K12.canny_fused_ref(g, 30.0, 60.0))


@pytest.mark.parametrize("shape", [(720, 1280), (1080, 1920), (1440, 2560)])
def test_canny_cluster_cap_binds_on_card(cuda, shape):
    """A gray serpentine whose weak contour is longer than H+W from one
    strong stretch, across every band: the cluster stops where the plain
    loop's cap stops."""
    g = torch.from_numpy(serpentine_gray(*shape))[None].to(cuda)
    want = K12.canny_fused_ref(g, 40.0, 150.0)
    cand = K12.canny_nms_ref(_reflect_pad(g.float(), 1, 1), 1600.0, 22500.0)[0]
    assert 0 < int(want.sum()) < int(cand.sum())
    for ranks in (None, 8):
        assert torch.equal(K12.canny_cluster(g, 40.0, 150.0, _ranks=ranks), want)
        assert torch.equal(K12.canny_cluster(g.float(), 40.0, 150.0, _ranks=ranks), want)


def test_canny_route_on_card_follows_the_byte_count(cuda):
    """The card's routing agrees with ``canny_route`` on its shared-memory
    limit, and a cluster launch the card refuses raises."""
    limit = K12._shared_limit(cuda)
    for h, w in ((480, 640), (576, 1024), (720, 1280), (1080, 1920), (2160, 3840),
                 (2560, 3840), (2561, 3840), (2880, 5120), (4320, 7680), (15708, 5120),
                 (15709, 5120), (8192, 12288)):
        route = K12.canny_route(h, w, limit, resident=torch.cuda.get_device_properties(
            cuda).multi_processor_count)
        assert K12.hysteresis_fits_shared(cuda, h, w) == (route == "fused")
        if route != "fused":
            assert K12.hysteresis_fits_cluster(cuda, h, w) == (route == "cluster")
        if route not in ("fused", "cluster"):
            assert K12.canny_fits_grid(cuda, h, w) == (route == "grid")
    g = torch.from_numpy(_gray(720, 1280, 1))[None].to(cuda)
    with pytest.raises(RuntimeError, match="status"):
        K12.canny_cluster(g, 30.0, 60.0, _ranks=17)  # above Hopper's 16
    big = torch.zeros((1, 2880, 5120), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="status"):
        K12.canny_cluster(big, 30.0, 60.0, _ranks=16)  # a band above a block's memory


@pytest.mark.parametrize("shape", [(24, 40), (23, 41)])
def test_hysteresis_cap_binds_on_card(cuda, shape):
    """A snake longer than H+W: both kernels must stop where the JAX loop's
    cap stops the plain version (whole-word and ragged rows)."""
    h, w = shape
    cand = torch.zeros(h, w, dtype=torch.bool)
    for y in range(0, h, 2):
        cand[y, 1:w - 1] = True
        if y + 1 < h:
            cand[y + 1, (w - 2) if (y // 2) % 2 == 0 else 1] = True
    strong = torch.zeros_like(cand)
    strong[0, 1] = True
    cand, strong = cand[None].to(cuda), strong[None].to(cuda)
    want = K12.hysteresis_ref(cand, strong)
    for form, blocks in (("shared", None), ("global", None), ("grid", None), ("grid", 5),
                         ("grid_global", None), ("grid_global", 7)):
        got = K12.canny_hysteresis(cand, strong, _form=form, _blocks=blocks)
        assert torch.equal(got, want)
        assert 0 < int(got.sum()) < int(cand.sum())


def test_hysteresis_form_follows_the_shape(cuda):
    """Every pyramid level of a 640x480 frame takes the shared-memory kernel;
    an image whose packed masks exceed a block's shared memory takes the
    global one, by shape alone."""
    assert all(K12.hysteresis_fits_shared(cuda, h, w)
               for h, w in ((480, 640), (240, 320), (120, 160), (576, 1024)))
    h, w = 720, 1280
    assert not K12.hysteresis_fits_shared(cuda, h, w)
    rng = np.random.default_rng(7)
    cand = torch.from_numpy(rng.random((1, h, w)) < 0.3).to(cuda)
    strong = cand & torch.from_numpy(rng.random((1, h, w)) < 0.01).to(cuda)
    assert torch.equal(K12.canny_hysteresis(cand, strong), K12.hysteresis_ref(cand, strong))
    with pytest.raises(ValueError):
        K12.canny_hysteresis(cand, strong, _form="shared")


def _grid_cases(shape):
    """(uint8 images, G of one launch of all of them or None, images a
    launch takes) on the card."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(torch.uint8)
    return imgs, K12._grid_blocks(torch.device("cuda"), h, w, b), \
        K12._grid_group(torch.device("cuda"), h, w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(1, 3072, 4096), (2, 3072, 4096), (3, 3072, 4096),
                                   (1, 2880, 5120), (2, 2880, 5120), (3, 2880, 5120),
                                   (1, 4320, 7680), (2, 4320, 7680), (3, 4320, 7680)])
def test_canny_grid_bit_equal(cuda, shape, dtype):
    """canny_batched on images above a cluster's memory: as many
    cooperative launches as groups of images the card holds at once (one
    at B = 1 and 2), nothing else, the plain version's edges; canny_grid
    at the card's G and at half of it where the band still fits a block
    (else that launch raises), a second launch bit-identical."""
    b, h, w = shape
    imgs, blocks, group = _grid_cases(shape)
    imgs = imgs.to(cuda, dtype)
    want = K12.canny_fused_ref(imgs, 30.0, 60.0)
    assert int(want.sum()) > 0 and group >= min(b, 2)
    before = _canny_counts()
    got = K12.canny_batched(imgs, 60.0, 30.0)
    assert _canny_counts() == (*before[:4], before[4] + -(-b // group))
    assert got.dtype == torch.bool and torch.equal(got, want)
    if blocks:
        for g in (None, blocks // 2):
            if g and K12.cluster_smem_bytes(h, w, g) > K12._shared_limit(cuda):
                with pytest.raises(RuntimeError, match="status"):
                    K12.canny_grid(imgs, 30.0, 60.0, _blocks=g)
                continue
            got = K12.canny_grid(imgs, 30.0, 60.0, _blocks=g)
            assert torch.equal(got, want)
            assert torch.equal(K12.canny_grid(imgs, 30.0, 60.0, _blocks=g), got)
    else:
        with pytest.raises(ValueError, match="do not fit"):
            K12.canny_grid(imgs, 30.0, 60.0)


@pytest.mark.parametrize("shape, blocks", [((2, 29, 70), 40), ((1, 50, 37), 8), ((1, 40, 65), 1),
                                           ((3, 33, 64), 2), ((1, 721, 1283), 100),
                                           ((2, 2, 2), 4), ((1, 2880, 5120), 40)])
def test_canny_grid_bands_ragged_and_empty(cuda, shape, blocks):
    """A forced G: bands that do not divide H, blocks whose band is empty
    (G > H), rows that end inside a word, one block alone: the plain
    version's edges."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda)
    for g in (imgs, imgs.to(torch.uint8)):
        assert torch.equal(K12.canny_grid(g, 30.0, 60.0, _blocks=blocks),
                           K12.canny_fused_ref(g, 30.0, 60.0))


@pytest.mark.parametrize("shape, blocks", [((120, 200), 7), ((2880, 5120), None)])
def test_canny_grid_cap_binds_on_card(cuda, shape, blocks):
    """A gray serpentine whose weak contour is longer than H+W from one
    strong stretch, across every band: the grid stops where the plain
    loop's cap stops."""
    g = torch.from_numpy(serpentine_gray(*shape))[None].to(cuda)
    want = K12.canny_fused_ref(g, 40.0, 150.0)
    cand = K12.canny_nms_ref(_reflect_pad(g.float(), 1, 1), 1600.0, 22500.0)[0]
    assert 0 < int(want.sum()) < int(cand.sum())
    assert torch.equal(K12.canny_grid(g, 40.0, 150.0, _blocks=blocks), want)
    assert torch.equal(K12.canny_grid(g.float(), 40.0, 150.0, _blocks=blocks), want)


def test_canny_grid_refused_launch_raises_and_the_next_runs(cuda):
    """More blocks than the card holds at once, and a band above a block's
    shared memory: the launch raises with its status, and the next launch
    runs and is right."""
    g = torch.from_numpy(_gray(720, 1280, 1))[None].to(cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    with pytest.raises(RuntimeError, match="status"):
        K12.canny_grid(g, 30.0, 60.0, _blocks=2 * n_sm + 1)
    big = torch.zeros((1, 2880, 5120), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="status"):
        K12.canny_grid(big, 30.0, 60.0, _blocks=2)
    with pytest.raises(RuntimeError, match="status"):
        K12.canny_hysteresis(big.bool(), big.bool(), _form="grid_global", _blocks=2 * n_sm + 1)
    assert torch.equal(K12.canny_grid(g, 30.0, 60.0), K12.canny_fused_ref(g, 30.0, 60.0))


@pytest.mark.parametrize("shape, blocks", [((1, 2880, 5120), None), ((2, 720, 1280), None),
                                           ((3, 37, 53), 8), ((2, 29, 70), 40),
                                           ((1, 1000, 1000), 3)])
def test_hysteresis_grid_forms_bit_equal(cuda, shape, blocks):
    """K2's grid form with its state in shared and in global memory, at the
    card's G and at a forced one (empty bands, ragged rows): the plain
    version's reach, one launch where the images fit together."""
    b, h, w = shape
    imgs = torch.from_numpy(np.stack([_gray(h, w, s) for s in range(b)])).to(cuda)
    c_p, s_p = K12.canny_nms_ref(_reflect_pad(imgs, 1, 1), 100.0, 3600.0)
    want = K12.hysteresis_ref(c_p, s_p)
    assert int(want.sum()) > int(s_p.sum())
    for form in ("grid", "grid_global"):
        before = K12.canny_hysteresis.launches
        assert torch.equal(K12.canny_hysteresis(c_p, s_p, _form=form, _blocks=blocks), want)
        assert K12.canny_hysteresis.launches == before + 1


@pytest.mark.parametrize("p", [0, 1, 3000, 16384, 65536])
def test_lgsx_kernel_close_and_deterministic(cuda, p):
    """K3 over ceil(P / 256) blocks (one at P = 0, which writes zeros):
    within rtol 1e-4 / atol 1e-5 of each output's largest entry of the
    plain version (reduction order), and the same bits from a second launch
    and from launches on two other streams, each with its own scratch."""
    rng = np.random.default_rng(2)
    wxp = rng.normal(size=(p, 3)).astype(np.float32)
    wxp[:, 2] = np.abs(wxp[:, 2]) + 0.5
    grads = (rng.normal(size=(p, 2)) * 50).astype(np.float32)
    r = rng.uniform(0, 3, p).astype(np.float32)
    w = np.where(rng.random(p) < 0.8, np.minimum(1.0, 0.3 / r), 0.0).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (wxp, grads, r, w)]
    before = K3.lgsx_reduce.launches
    got = K3.lgsx_reduce(*args)
    assert K3.lgsx_reduce.launches == before + 1
    want = K3.lgsx_reduce_ref(*args)
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())
    again = K3.lgsx_reduce(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize(cuda)
    outs = []
    for s in streams:
        with torch.cuda.stream(s):
            outs.append(K3.lgsx_reduce(*args))
    torch.cuda.synchronize(cuda)
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(got, out))


@pytest.mark.parametrize("quad_form", TABLE_FORMS)
@pytest.mark.parametrize("pose", ["identity", "tracked", "out"])
@pytest.mark.parametrize("size", [(640, 480, 16384), (320, 240, 4864), (160, 120, 1000)])
def test_residual_lgsx_kernel_counts_equal_sums_close_deterministic(cuda, size, pose, quad_form):
    """The fused kernel against its plain version on the card, in every
    row layout (dt quad f32 / bf16, 12-component quad f32 / bf16,
    structure): one launch, no other work; counts equal; floats within 1e-5
    of the largest entry; the same bits from a second launch."""
    w, h, p = size
    cam = dict(CAM, width=w, height=h, fx=CAM["fx"] * w / 160, fy=CAM["fy"] * w / 160,
               cx=CAM["cx"] * w / 160, cy=CAM["cy"] * w / 160)
    quad, pts, valid = make_inputs(p, p, quad_form, cam)
    args = torch_args(quad, pts, valid, *make_pose(pose), quad_form, device=cuda, cam=cam)
    before = K3.residual_lgsx.launches
    got = solver._residual_sums(*args)
    assert K3.residual_lgsx.launches == before + 1
    want = K3.residual_lgsx_ref(*args)
    assert int(got[4]) == int(want[4]) and int(got[5]) == int(want[5])
    assert int(got[4]) + int(got[5]) == int(valid.sum())
    if pose == "out":
        assert int(got[5]) > int(got[4])
    for a, b in zip(got[:4], want[:4]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    again = K3.residual_lgsx(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shared_cloud", [True, False])
@pytest.mark.parametrize("quad_form", TABLE_FORMS)
def test_residual_lgsx_batched_lanes_equal_one_lane_launches(cuda, quad_form, shared_cloud):
    """The fused kernel over 8 lanes (poses cycling identity / tracked /
    out, a table per lane, one cloud shared by stride 0 or one per lane):
    each lane bit-equal to its B = 1 launch, counts equal to the plain
    version, floats within 1e-5 of the largest entry; lanes left out by
    ``active`` keep their rows; a second launch gives the same bits."""
    b, p = 8, 4864
    kinds = ("identity", "tracked", "out")
    tables = [make_inputs(seed, p, quad_form)[0] for seed in range(b)]
    clouds = [make_inputs(10 + seed, p, quad_form)[1:] for seed in range(b)]
    dtype = torch.bfloat16 if quad_form in BF16_FORMS else torch.float32
    quad = torch.from_numpy(np.stack(tables)).to(dtype).to(cuda)
    if shared_cloud:
        pts, valid = (torch.from_numpy(x).to(cuda) for x in clouds[0])
        cloud = EdgeCloud(pts[None].expand(b, p, 3), valid[None].expand(b, p), None)
    else:
        cloud = EdgeCloud(torch.from_numpy(np.stack([c[0] for c in clouds])).to(cuda),
                             torch.from_numpy(np.stack([c[1] for c in clouds])).to(cuda), None)
    R = torch.from_numpy(np.stack([make_pose(kinds[i % 3])[0] for i in range(b)])).to(cuda)
    t = torch.from_numpy(np.stack([make_pose(kinds[i % 3])[1] for i in range(b)])).to(cuda)
    cam = CameraConfig(**CAM)
    rest = (6.0, 0.3, True)
    out = torch.empty((b, 46), device=cuda)
    before = K3.residual_lgsx.launches
    got = K3.residual_lgsx_batched(quad, cloud, cam, R, t, *rest, None, out)
    assert K3.residual_lgsx.launches == before + 1
    rows = out.clone()
    want = K3.residual_lgsx_batched_ref(quad, cloud, cam, R, t, *rest)
    for i in range(b):
        one = torch.empty((1, 46), device=cuda)
        lane = EdgeCloud(cloud.points[i:i + 1], cloud.valid[i:i + 1], None)
        K3.residual_lgsx_batched(quad[i:i + 1], lane, cam, R[i:i + 1], t[i:i + 1], *rest, None,
                                 one)
        assert torch.equal(one[0].view(torch.int32), rows[i].view(torch.int32))
    assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
    assert int(got[5][2]) > int(got[4][2])
    for a, w in zip(got[:4], want[:4]):
        a, w = a.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    keep = torch.tensor([i % 2 == 0 for i in range(b)], device=cuda)
    held = torch.full((b, 46), -7.0, device=cuda)
    K3.residual_lgsx_batched(quad, cloud, cam, R, t, *rest, keep, held)
    assert torch.equal(held[keep].view(torch.int32), rows[keep].view(torch.int32))
    assert bool((held[~keep] == -7.0).all())
    K3.residual_lgsx_batched(quad, cloud, cam, R, t, *rest, None, out)
    assert torch.equal(out.view(torch.int32), rows.view(torch.int32))


def test_track_frames_batched_on_card_lanes_bit_equal(cuda):
    """Three 160x120 frames tracked as one batch on the card (LM, lanes
    from identity and from a perturbed pose): each lane's result bit-equal
    to the same lane tracked alone on the card."""
    from revo_tpu_torch import lie, tracker

    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg = SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))
    scene = SyntheticScene()
    traj = scene.trajectory(4, seed=3)
    rendered = [render_frame(scene, cam, T, seed=3000 + i) for i, T in enumerate(traj)]
    g = torch.from_numpy(np.stack([x.astype(np.uint8) for x, _ in rendered])).to(cuda)
    d = torch.from_numpy(np.stack([(y * 5000.0).astype(np.uint16) for _, y in rendered])).to(cuda)
    kf = frontend.make_keyframe(frontend.build_frame(g[0], d[0], cfg),
                                torch.eye(4, device=cuda), cfg)
    frames = frontend.build_frame_batched(g[1:], d[1:], cfg)
    dR, dt = lie.exp_se3(torch.tensor([0.01, -0.008, 0.006, 0.004, -0.003, 0.005]))
    R0 = torch.stack([torch.eye(3), torch.eye(3), dR]).to(cuda)
    t0 = torch.stack([torch.zeros(3), torch.zeros(3), dt]).to(cuda)
    res = tracker.track_frames_batched(
        lanes.add_lane_axis(kf._replace(frame=None), 3), frames, R0, t0, cfg)
    for i in range(3):
        one = tracker.track_frames(kf, lanes.lane(frames, i), R0[i], t0[i], cfg)
        for a, b in zip(lanes.lane(res, i), one):
            assert torch.equal(a.cpu(), b.cpu())


def test_build_frame_on_card_matches_cpu(cuda):
    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg = SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))
    g, d = render_frame(SyntheticScene(), cam, np.eye(4, dtype=np.float32), seed=5)
    g8 = torch.from_numpy(g.astype(np.uint8))
    d16 = torch.from_numpy((d * 5000.0).astype(np.uint16))
    before = _canny_counts()
    f_card = frontend.build_frame(g8.to(cuda), d16.to(cuda), cfg)
    assert _canny_counts() == (before[0] + 3, *before[1:])
    f_cpu = frontend.build_frame(g8, d16, cfg)
    for a, b in zip(f_card.levels, f_cpu.levels):
        assert torch.equal(a.edges.cpu(), b.edges)
        assert torch.equal(a.cloud.valid.cpu(), b.cloud.valid)
        assert int(a.cloud.count) == int(b.cloud.count)
        torch.testing.assert_close(a.cloud.points.cpu(), b.cloud.points, rtol=1e-6, atol=0)


def _fill_gray(b, h, w):
    """(B, H, W) uint8-valued float32 gray: smooth lanes (sparse edges,
    their coarse levels filled) and, every other lane, 8x8 blocks of texture
    (dense edges, left as they are); lanes repeat from the 16th on."""
    out = []
    for i in range(min(b, 16)):
        g = _gray(h, w, 100 + i)
        if i % 2:
            rng = np.random.default_rng(i)
            tex = rng.integers(-60, 61, size=(h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)
            g = np.clip(g + tex[:h, :w], 0, 255).astype(np.float32)
        out.append(g)
    return np.stack([out[i % len(out)] for i in range(b)])


@pytest.mark.parametrize("lanes, h, w", [(1, 480, 640), (8, 480, 640), (128, 480, 640),
                                         (2, 720, 1280), (3, 481, 643)])
def test_fill_in_levels_kernel_bit_equal(cuda, lanes, h, w):
    """The front end's levels on the card: every level's edges_orig is
    Canny's, level 0's edges are its edges_orig, and levels 1-2 after
    revo_fill_levels (one launch a frame; from build_frame_batched too where
    each level's depth has its gray's size) equal fill_in_levels_ref's on the
    CPU, flags included, bit for bit."""
    from revo_tpu_torch.ops import edge_hist

    cfg = SystemConfig()
    pyr = cfg.pyramid
    gray = torch.from_numpy(_fill_gray(lanes, h, w)).to(cuda)
    depth = torch.ones_like(gray)
    before = edge_hist.fill_in_levels.launches
    out = list(frontend.edge_levels(gray, depth, cfg))
    assert edge_hist.fill_in_levels.launches == before + 1
    for g, _, edges_orig, _ in out:
        assert torch.equal(edges_orig, K12.canny_batched(g, pyr.canny_threshold1,
                                                         pyr.canny_threshold2))
    assert out[0][3] is out[0][2]
    orig = [edges_orig.cpu() for _, _, edges_orig, _ in out]
    want, want_flags = edge_hist.fill_in_levels_ref(orig, pyr.dist_patch_sizes, pyr.n_percentage)
    for (_, _, _, edges), wanted in zip(out[1:], want):
        assert edges.dtype == torch.bool and torch.equal(edges.cpu(), wanted)
    got, flags = edge_hist.fill_in_levels([e.to(cuda) for e in orig], pyr.dist_patch_sizes,
                                           pyr.n_percentage)
    assert torch.equal(flags.cpu(), want_flags)
    if lanes > 1:
        assert want_flags.any() and not want_flags.all()
    if h % 4 or w % 4:  # the clouds want each level's depth of its gray's size
        return
    before = edge_hist.fill_in_levels.launches
    frame = frontend.build_frame_batched(gray, depth, cfg)
    torch.cuda.synchronize()
    assert edge_hist.fill_in_levels.launches == before + 1
    for lv, wanted in zip(frame.levels[1:], want):
        assert torch.equal(lv.edges.cpu(), wanted)


@pytest.mark.parametrize("case", ["ten_levels", "global_maps", "row_tiles", "rows_a_tile"])
def test_fill_in_levels_kernel_chains_and_tiles(cuda, case):
    """revo_fill_levels where its layout changes, against the plain version:
    ten levels (two launches, the second's parent the first's last output),
    bit maps too large for shared memory (global memory), count tiles of
    part of a bin row (20,000 bins a row, more than a block's slots) and of
    several bin rows with the bit maps in shared memory."""
    from revo_tpu_torch.ops import edge_hist

    rng = np.random.default_rng(len(case))
    lanes = 2
    if case == "ten_levels":
        sizes, patches = [(720, 1280)], (20, 10, 5, 5, 3, 2, 2, 1, 1, 1)
        density = (0.08, 0.004, 0.004, 0.02, 0.02, 0.05, 0.05, 0.2, 0.2, 0.3)
    elif case == "global_maps":
        sizes, patches, density, lanes = [(2048, 4096)], (2, 1), (0.1, 0.2), 1
    elif case == "row_tiles":  # 20,000 bins a row: tiles of part of it
        sizes, patches, density = [(4, 40000)], (2, 1), (0.08, 0.1)
    else:  # 1,000 bins a row, 600 rows: tiles of 16 rows, the maps in shared memory
        sizes, patches, density = [(1200, 2000)], (2, 1), (0.08, 0.1)
    while len(sizes) < len(patches):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    levels = [torch.from_numpy(rng.random((lanes, hh, ww)) < d)
              for (hh, ww), d in zip(sizes, density)]
    want, want_flags = edge_hist.fill_in_levels_ref(levels, patches, 0.3)
    before = edge_hist.fill_in_levels.launches
    got, flags = edge_hist.fill_in_levels([e.to(cuda) for e in levels], patches, 0.3)
    assert edge_hist.fill_in_levels.launches == before + (2 if case == "ten_levels" else 1)
    assert torch.equal(flags.cpu(), want_flags) and want_flags.any()
    for g, wanted in zip(got, want):
        assert torch.equal(g.cpu(), wanted)


def test_fill_in_share_traced_without_host_reads(cuda):
    """The fill-in's flags reach ``trace.snapshot()`` as
    ``frontend.fill_in_share``, read off the step's path: building frames
    while tracing adds no host read."""
    from revo_tpu_torch.ops import edge_hist
    from revo_tpu_torch.utils import trace

    cfg = SystemConfig()
    pyr = cfg.pyramid
    gray = torch.from_numpy(_fill_gray(4, 480, 640)).to(cuda)
    reads = dict(trace.host_reads)
    trace.enable()
    try:
        for _ in range(2):
            frontend.build_frame_batched(gray, torch.ones_like(gray), cfg)
        assert dict(trace.host_reads) == reads
        snap = trace.snapshot()
    finally:
        trace.disable()
    frame = frontend.build_frame_batched(gray, torch.ones_like(gray), cfg)
    _, flags = edge_hist.fill_in_levels_ref([lv.edges_orig.cpu() for lv in frame.levels],
                                            pyr.dist_patch_sizes, pyr.n_percentage)
    assert snap["frontend.fill_in_share"] == int(flags.sum()) / flags.numel()
    assert 0.0 < snap["frontend.fill_in_share"] < 1.0


def test_vosystem_pan_on_card_matches_cpu(cuda):
    """VOSystem over a 160x120 fast pan (4 cm + ~1 deg per frame, the motion
    of tests/test_system.py) on the card: the same promotion /
    relocalization / lost flags as on the CPU, poses within 1e-4."""
    from revo_tpu_torch import lie, system

    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    cfg = SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))
    step = lie.matrix_from_rt(*lie.exp_se3(
        torch.tensor([0.04, 0.0, 0.005, 0.0, 0.017, 0.0]))).numpy()
    T = np.eye(4, dtype=np.float32)
    frames = []
    for i in range(20):
        frames.append((*render_frame(SyntheticScene(), cam, T), i / 30.0))
        T = T @ step
    runs = []
    for device in (cuda, "cpu"):
        vo = system.VOSystem(cfg, device=device)
        poses, flags = [], []
        for g, d, ts in frames:
            before = (vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost)
            poses.append(vo.process_frame(g, d, ts))
            flags.append((vo.n_keyframes - before[0], vo.n_relocalized - before[1],
                          vo.n_tracking_lost - before[2]))
        runs.append((np.stack(poses), flags))
    (p_card, f_card), (p_cpu, f_cpu) = runs
    assert f_card == f_cpu
    assert sum(f[0] for f in f_card[1:]) >= 1  # the pan promotes
    np.testing.assert_allclose(p_card[:, :3, 3], p_cpu[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_card[:, :3, :3], p_cpu[:, :3, :3], rtol=0, atol=1e-4)


def _small_cfg():
    cam = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)
    return SystemConfig(camera=cam, pyramid=dataclasses.replace(
        SystemConfig().pyramid, edge_capacity=(4096, 2048, 1024)))


def test_close_loops_on_card_matches_cpu(cuda):
    """The four loop keyframes of chip_smoke's phase 10 at 160x120: edge
    (0, 3) accepted on both devices, corrected poses within 1e-4."""
    from chip_smoke import loop_keyframes
    from revo_tpu_torch import loopclosure

    cfg = _small_cfg()
    runs = []
    for device in (cuda, "cpu"):
        kfs, gt, drifted = loop_keyframes(cfg, device)
        corrected, loops = loopclosure.close_loops(kfs, cfg, min_separation=2, radius=0.3)
        runs.append((corrected, [(e.a, e.b) for e in loops]))
    assert runs[0][1] == runs[1][1] == [(0, 3)]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-4)
    derr = np.linalg.norm(drifted[3, :3, 3] - gt[3, :3, 3])
    assert np.linalg.norm(runs[0][0][3, :3, 3] - gt[3, :3, 3]) < 0.6 * derr


def test_resume_on_card_is_bit_equal(cuda, tmp_path):
    """VOSystem cut at frame 6 and restored from its checkpoint file, and
    vo_scan continued from a saved scan state: the continuous card run's
    poses bit for bit."""
    from revo_tpu_torch import checkpoint, system
    from revo_tpu_torch.io.synthetic import render_sequence
    from revo_tpu_torch.parallel import batch

    cfg = _small_cfg()
    frames = [(g, d, ts) for g, d, _, ts in render_sequence(SyntheticScene(), cfg.camera, 12, seed=2)]

    def run(vo, part):
        return np.stack([vo.process_frame(g, d, ts) for g, d, ts in part])

    full = run(system.VOSystem(cfg, device=cuda), frames)
    vo_a = system.VOSystem(cfg, device=cuda)
    run(vo_a, frames[:6])
    path = str(tmp_path / "vo.npz")
    checkpoint.save(path, checkpoint.capture(vo_a))
    vo_b = system.VOSystem(cfg, device=cuda)
    checkpoint.restore(vo_b, checkpoint.load(path), vo_a.prev_frame)
    np.testing.assert_array_equal(run(vo_b, frames[6:]), full[6:])

    grays = torch.from_numpy(np.stack([f[0] for f in frames])).to(cuda)
    depths = torch.from_numpy(np.stack([f[1] for f in frames])).to(cuda)
    scan_full = batch.vo_scan(grays, depths, cfg)[0]
    path = str(tmp_path / "scan.npz")
    checkpoint.save_scan_state(path, batch.vo_scan(grays[:6], depths[:6], cfg)[2],
                               cfg.tracker.optimizer.quad_form)
    state = checkpoint.load_scan_state(path, cfg, device=cuda)
    assert state.kf.quads[0].is_cuda and state.kf.quads[0].dtype == torch.bfloat16
    tail = batch.vo_scan_from_state(state, grays[6:], depths[6:], cfg)[0]
    assert torch.equal(tail, scan_full[6:])


def _pan_frames(cam, n):
    from revo_tpu_torch import lie

    step = lie.matrix_from_rt(*lie.exp_se3(
        torch.tensor([0.04, 0.0, 0.005, 0.0, 0.017, 0.0]))).numpy()
    T = np.eye(4, dtype=np.float32)
    frames, gt = [], []
    for _ in range(n):
        frames.append(render_frame(SyntheticScene(), cam, T))
        gt.append(T.copy())
        T = T @ step
    return frames, np.stack(gt)


def test_windowed_ba_on_card_matches_cpu(cuda):
    """chip_smoke's phase 12 at 160x120: six pan keyframes with perturbed
    stored poses; one assembled system and the refined poses, card against
    the same keyframes on the CPU."""
    from chip_smoke import (ba_keyframes, max_translation_error, perturbed_poses, to_device)
    from revo_tpu_torch.parallel import windowed

    cfg = _small_cfg()
    frames, gt = _pan_frames(cfg.camera, 11)
    gt = gt[::2]
    stored = perturbed_poses(gt)
    kfs = ba_keyframes(cfg, cuda, [f[0] for f in frames[::2]], [f[1] for f in frames[::2]], stored)
    kfs_cpu = [to_device(k, "cpu") for k in kfs]
    assert kfs[0].structs[0].is_cuda and not kfs_cpu[0].structs[0].is_cuda

    def system_of(keyframes):
        dev = keyframes[0].T_w_k.device
        win = windowed.keyframe_window(keyframes, 0, torch.from_numpy(stored).to(dev))
        return windowed._accumulate_pairs(
            win, *windowed.make_pairs(6, 2, device=dev), cfg.camera_pyramid()[0],
            cfg.tracker.optimizer, 0, 6)

    for a, b in zip(system_of(kfs), system_of(kfs_cpu)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    card = windowed.refine_keyframes(kfs, cfg)
    cpu = windowed.refine_keyframes(kfs_cpu, cfg)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-3)
    np.testing.assert_allclose(card[0], stored[0], atol=1e-6)  # the gauge
    assert max_translation_error(card, gt) < 0.7 * max_translation_error(stored, gt)


def test_undistort_on_card_matches_cpu(cuda):
    """chip_smoke's phase 14 at 160x120: a distorted capture of the pan
    through VOSystem(undistort=True) on the card and on the CPU."""
    from chip_smoke import TUM_FR1_DISTORTION, distort_capture
    from revo_tpu_torch import system
    from revo_tpu_torch.ops.undistort import build_undistort_maps

    base = _small_cfg()
    cam = dataclasses.replace(base.camera, distortion=TUM_FR1_DISTORTION)
    cfg = dataclasses.replace(base, camera=cam,
                              pyramid=dataclasses.replace(base.pyramid, undistort=True))
    frames, _ = _pan_frames(cam, 8)
    captured = [distort_capture(g, d, cam) for g, d in frames]
    maps = build_undistort_maps(cam)
    g, d = captured[0]
    f_card = frontend.build_frame(
        torch.from_numpy(g).to(cuda), torch.from_numpy(d).to(cuda), cfg,
        tuple(torch.from_numpy(m).to(cuda) for m in maps))
    f_cpu = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), cfg,
                                 tuple(torch.from_numpy(m) for m in maps))
    for a, b in zip(f_card.levels, f_cpu.levels):
        assert torch.equal(a.gray.cpu(), b.gray) and torch.equal(a.edges.cpu(), b.edges)
        assert torch.equal(a.depth.cpu(), b.depth)
    runs = []
    for device in (cuda, "cpu"):
        vo = system.VOSystem(cfg, device=device)
        assert vo.undistort_maps[0].device.type == torch.device(device).type
        poses = np.stack([vo.process_frame(g, d, i / 30.0) for i, (g, d) in enumerate(captured)])
        runs.append((poses, vo.n_keyframes, vo.n_relocalized, vo.n_tracking_lost))
    assert runs[0][1:] == runs[1][1:]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-4)


def test_segments_on_card_match_cpu(cuda):
    """track_long_sequence over a 13-frame pan in 4 segments on the card:
    the CPU's stitched trajectory within 5e-4, with and without refine."""
    from revo_tpu_torch.parallel import segments

    cfg = _small_cfg()
    frames, _ = _pan_frames(cfg.camera, 13)
    grays = torch.from_numpy(np.stack([f[0] for f in frames]))
    depths = torch.from_numpy(np.stack([f[1] for f in frames]))
    for refine in (False, True):
        card = segments.track_long_sequence(grays.to(cuda), depths.to(cuda), cfg, 4, refine=refine)
        cpu = segments.track_long_sequence(grays, depths, cfg, 4, refine=refine)
        assert card.is_cuda and card.shape == (13, 4, 4)
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0, atol=5e-4)
