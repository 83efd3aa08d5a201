"""revo_tpu_torch image and geometry ops against revo_tpu's on the same
seeded inputs (CPU).

Tolerances: bit-equal for bool/int outputs (edges, counts, cloud validity,
count and slot order), for ops that are exact in float32 on uint8-valued
input (pyrDown, Sobel, depth subsampling), for the EDT (exact squared
distances and correctly rounded roots), its structure and the dt sampler
against jitted JAX; rtol 1e-6 / atol 1e-5 where a test also holds the EDT
to OpenCV's; cloud points rtol 1e-6.
"""
import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import ops as jops
from revo_tpu.ops.interp import bilinear_sample_dtquad as j_dtquad
from revo_tpu_torch.ops import backproject as tbp
from revo_tpu_torch.ops import depth as tdepth
from revo_tpu_torch.ops import edge_hist as thist
from revo_tpu_torch.ops import edt as tedt
from revo_tpu_torch.ops import filters as tfilt
from revo_tpu_torch.ops.interp import bilinear_sample_dtquad as t_dtquad
from revo_tpu_torch.ops.project import sqrt_rn

from test_ops import synthetic_depth, synthetic_gray
from test_torch_frontend_kernels import jax_fill

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _edges(seed, h=120, w=160):
    img = synthetic_gray(h=h, w=w, seed=seed)
    return cv2.Canny(img, 150, 100, apertureSize=3, L2gradient=True) > 0


class TestFilters:
    @pytest.mark.parametrize("shape", [(120, 160), (61, 79)])
    def test_pyr_down_bit_equal(self, shape):
        img = synthetic_gray(*shape, seed=1).astype(np.float32)
        want = np.asarray(jops.pyr_down(jnp.asarray(img)))
        got = tfilt.pyr_down(_t(img)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_sobel_bit_equal(self):
        img = synthetic_gray(seed=3).astype(np.float32)
        gxj, gyj = jops.sobel(jnp.asarray(img))
        gxt, gyt = tfilt.sobel(_t(img))
        np.testing.assert_array_equal(gxt.numpy(), np.asarray(gxj))
        np.testing.assert_array_equal(gyt.numpy(), np.asarray(gyj))

    def test_gaussian_blur_bit_equal(self):
        img = synthetic_gray(seed=4).astype(np.float32)
        want = np.asarray(jops.gaussian_blur(jnp.asarray(img)))
        np.testing.assert_array_equal(tfilt.gaussian_blur(_t(img)).numpy(), want)


@pytest.mark.parametrize("shape", [(120, 160), (59, 81)])
def test_subsample_depth_bit_equal(shape):
    d = synthetic_depth(*shape, seed=5, hole_frac=0.3)
    want = np.asarray(jops.subsample_depth_with_holes(jnp.asarray(d)))
    np.testing.assert_array_equal(tdepth.subsample_depth_with_holes(_t(d)).numpy(), want)


class TestEdgeHist:
    @pytest.mark.parametrize("patch", [5, 10, 20])
    def test_patch_histogram_bit_equal(self, patch):
        e = _edges(6)
        cj, oj = jops.patch_histogram(jnp.asarray(e), patch)
        ct, ot = thist.patch_histogram(_t(e), patch)
        assert ct.dtype == torch.int32
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert float(ot) == float(oj)

    def test_fill_in_bit_equal(self):
        rng = np.random.default_rng(11)
        parent = rng.random((120, 160)) < 0.08
        child = rng.random((60, 80)) < 0.002
        counts, _ = jops.patch_histogram(jnp.asarray(child), 10)
        want = np.asarray(jops.fill_in_edges(
            jnp.asarray(child), jnp.asarray(parent), counts, 10, 20))
        got = thist.fill_in_edges(
            _t(child), _t(parent), _t(np.asarray(counts)), 10, 20).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() > child.sum()

    @staticmethod
    def _pyramid_edges(shape, seed, t_hi, t_lo):
        """Canny edges of a synthetic image's pyrDown pyramid, 3 levels."""
        img = synthetic_gray(*shape, seed=seed)
        levels = []
        for _ in range(3):
            levels.append(cv2.Canny(img, t_hi, t_lo, apertureSize=3, L2gradient=True) > 0)
            img = cv2.pyrDown(img)
        return levels

    @staticmethod
    def _half_occupied():
        """Level 1 (60x80, 10x10 patches) with an edge in 24 of its 48
        patches: occupancy exactly 0.5; levels 0 and 2 dense."""
        rng = np.random.default_rng(13)
        child = np.zeros((60, 80), bool)
        for k in rng.permutation(48)[:24]:
            child[10 * (k // 8) + 4, 10 * (k % 8) + 6] = True
        return [rng.random((120, 160)) < 0.2, child, rng.random((30, 40)) < 0.5]

    @pytest.mark.parametrize("case", ["astra", "fr1", "ragged", "at_n_percentage",
                                      "above_n_percentage", "no_edge_hist"])
    def test_fill_in_levels_bit_equal(self, case):
        """fill_in_levels' plain version (levels 1 on, each from the filled
        level above; no level-0 histogram) against JAX's sequence, on lanes of
        Astra-like (Canny 60/20) and fr1-like (150/100) edges, on a size of
        no whole number of patches, at occupancy exactly n_percentage and
        just above it; with use_edge_hist false the front end yields Canny's
        edges at every level and records no fill-in."""
        from revo_tpu_torch import frontend
        from revo_tpu_torch.config import SystemConfig
        from revo_tpu_torch.utils import trace

        patches, n_pct = (20, 10, 5), 0.3
        if case == "no_edge_hist":
            cfg = SystemConfig()
            cfg = dataclasses.replace(cfg, pyramid=dataclasses.replace(cfg.pyramid,
                                                                       use_edge_hist=False))
            gray = torch.from_numpy(np.stack([synthetic_gray(seed=s) for s in (1, 2)]))
            trace.enable()
            try:
                out = list(frontend.edge_levels(gray, torch.ones(gray.shape), cfg))
                assert trace.snapshot()["frontend.fill_in_share"] is None
            finally:
                trace.disable()
            for _, _, edges_orig, edges in out:
                assert edges is edges_orig
            return
        if case in ("astra", "fr1"):
            t_hi, t_lo = (60, 20) if case == "astra" else (150, 100)
            lanes = [self._pyramid_edges((120, 160), seed, t_hi, t_lo) for seed in (3, 6, 9)]
        elif case == "ragged":
            lanes = [self._pyramid_edges((123, 157), seed, 150, 100) for seed in (4, 5)]
        else:
            lanes = [self._half_occupied()]
            n_pct = 0.5 if case == "at_n_percentage" else 0.50000006  # float32 just above
        got, flags = thist.fill_in_levels(
            [torch.from_numpy(np.stack([lv[k] for lv in lanes])) for k in range(3)], patches,
            n_pct)
        assert flags.shape == (len(lanes), 2) and flags.dtype == torch.bool
        for i, lane_levels in enumerate(lanes):
            want, want_flags = jax_fill(lane_levels, patches, n_pct)
            assert flags[i].tolist() == want_flags
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[i].numpy(), w)
        if case == "at_n_percentage":
            assert flags[0].tolist() == [False, False]
        if case == "above_n_percentage":
            assert flags[0, 0] and got[0][0].sum() > lanes[0][1].sum()
        if case == "fr1":
            assert flags.any()  # sparse levels are filled


class TestEDT:
    @pytest.mark.parametrize("seed", [2, 8])
    def test_matches_jax_and_opencv(self, seed):
        e = _edges(seed)
        got = tedt.distance_transform(_t(e)).numpy()
        want = np.asarray(jops.distance_transform(jnp.asarray(e)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        cvd = cv2.distanceTransform(
            (~e).astype(np.uint8) * 255, cv2.DIST_L2, cv2.DIST_MASK_PRECISE
        )
        np.testing.assert_allclose(got, cvd, atol=2e-2)

    def test_sparse_and_empty(self):
        e = np.zeros((33, 47), bool)
        e[10, 20] = True
        yy, xx = np.mgrid[0:33, 0:47]
        np.testing.assert_allclose(
            tedt.distance_transform(_t(e)).numpy(),
            np.sqrt((yy - 10.0) ** 2 + (xx - 20.0) ** 2), rtol=1e-6, atol=1e-5,
        )
        z = np.zeros((16, 24), bool)
        np.testing.assert_array_equal(
            tedt.distance_transform(_t(z)).numpy(),
            np.asarray(jops.distance_transform(jnp.asarray(z))),
        )

    @pytest.mark.parametrize("form", ["dt4", "dt4bf"])
    def test_struct_and_quad_match(self, form):
        e = _edges(9)
        sj = jops.keyframe_structure(jnp.asarray(e))
        st = tedt.keyframe_structure(_t(e))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-5)
        qj = np.asarray(jops.quad_structure(sj, form)).astype(np.float32)
        qt = tedt.quad_structure(st, form)
        assert qt.shape == (120 * 160, 4)
        assert qt.dtype == (torch.bfloat16 if form == "dt4bf" else torch.float32)
        np.testing.assert_allclose(qt.float().numpy(), qj, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("form", ["dt4", "dt4bf"])
def test_bilinear_sample_dtquad_matches(form):
    """Against the jitted JAX sampler (as the solver runs it: XLA fuses its
    sums of products into FMAs, which the port reproduces), bit for bit."""
    e = _edges(10)
    s = jops.keyframe_structure(jnp.asarray(e))
    qj = jops.quad_structure(s, form)
    qt = tedt.quad_structure(tedt.keyframe_structure(_t(e)), form)
    rng = np.random.default_rng(12)
    u = rng.uniform(1.0, 157.9, 4096).astype(np.float32)
    v = rng.uniform(1.0, 117.9, 4096).astype(np.float32)
    u[:64] = np.round(u[:64])  # integer coordinates: the floor knife edge
    sample = jax.jit(lambda q, u_, v_: j_dtquad(q, u_, v_, h=120, w=160))
    want = np.asarray(sample(qj, jnp.asarray(u), jnp.asarray(v)))
    got = t_dtquad(qt, _t(u), _t(v), 120, 160).numpy()
    np.testing.assert_array_equal(got, want)


def test_sqrt_rn_matches_numpy():
    """project.sqrt_rn, the port's square root on the CPU, bit-equal to
    numpy's correctly rounded one: every float32 integer below 2^24 (the
    EDT's squared distances) and 1e6 seeded random float32 values."""
    chunk = 1 << 22
    for lo in range(0, 1 << 24, chunk):
        x = np.arange(lo, lo + chunk, dtype=np.float32)
        np.testing.assert_array_equal(sqrt_rn(_t(x)).numpy(), np.sqrt(x))
    rng = np.random.default_rng(21)
    x = np.concatenate([rng.random(500_000, np.float32),
                        np.exp(rng.uniform(-80, 80, 500_000)).astype(np.float32)])
    got = sqrt_rn(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))


@pytest.mark.parametrize("seed", [2, 8, 10])
def test_edt_bit_equal_to_jax(seed):
    """The 160x120 EDT and keyframe structure bit-equal to the JAX
    package's (exact squared distances, correctly rounded roots)."""
    e = _edges(seed)
    np.testing.assert_array_equal(tedt.distance_transform(_t(e)).numpy(),
                                  np.asarray(jops.distance_transform(jnp.asarray(e))))
    np.testing.assert_array_equal(tedt.keyframe_structure(_t(e)).numpy(),
                                  np.asarray(jops.keyframe_structure(jnp.asarray(e))))


class TestBackproject:
    @pytest.mark.parametrize(
        "density,capacity",
        [(0.06, 4096), (0.06, 1500), (0.5, 1024), (0.0, 256), (0.061, 1170)],
        ids=["fits", "overflow", "heavy-overflow", "empty", "near-capacity"],
    )
    def test_matches_jax(self, density, capacity):
        rng = np.random.default_rng(13)
        edges = rng.random((120, 160)) < density
        depth = synthetic_depth(seed=14, hole_frac=0.2)
        depth[rng.random(depth.shape) < 0.02] = np.nan
        kw = dict(fx=150.0, fy=151.0, cx=80.0, cy=60.0, depth_min=0.1,
                  depth_max=5.2, capacity=capacity)
        cj = jops.backproject_edges(jnp.asarray(edges), jnp.asarray(depth),
                                    compaction="rank_sort2", **kw)
        ct = tbp.backproject_edges(_t(edges), _t(depth), **kw)
        assert int(ct.count) == int(cj.count)
        assert ct.count.dtype == torch.int32
        np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid))
        # Slot order: the same pixel in every slot.
        from revo_tpu.ops.backproject import _compact_rank

        mask = edges & (depth > np.float32(0.1)) & (depth < np.float32(5.2))
        ij, vj, _ = _compact_rank(jnp.asarray(mask), capacity, table_impl="sort_packed")
        it, vt, _ = tbp.compact(_t(mask), capacity)
        np.testing.assert_array_equal(
            it.numpy() * vt.numpy(), np.asarray(ij) * np.asarray(vj)
        )
        np.testing.assert_allclose(
            ct.points.numpy(), np.asarray(cj.points), rtol=1e-6, atol=0
        )
        assert np.isfinite(ct.points.numpy()).all()

    def test_overflow_decimation_slots(self):
        """All-valid 16x16 into 100 slots: slot j holds the highest pos with
        floor(pos * 100 / 256) == j, in float32."""
        edges = np.ones((16, 16), bool)
        depth = np.ones((16, 16), np.float32)
        idx, valid, count = tbp.compact(_t(edges & (depth > 0)), 100)
        assert int(count) == 256 and bool(valid.all())
        scale = np.float32(100) / np.float32(256)
        pos = np.arange(256, dtype=np.float32)
        slot = np.floor(pos * scale).astype(np.int64)
        want = np.array([np.max(np.nonzero(slot == j)[0]) for j in range(100)])
        np.testing.assert_array_equal(idx.numpy(), want)
