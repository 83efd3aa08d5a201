"""The port's native PNG decoder + prefetcher binding
(revo_tpu_torch/io/native_loader.py): the cases of tests/test_native_io.py on
it, against the cv2 oracle and against the JAX package's binding (byte-equal
decodes), and the shared loader (revo_tpu_torch/io/_native.py): a tracked
library that is missing is rebuilt with g++ under build/revo_tpu_torch/native/,
one that cannot be built is "unavailable" with the reason kept.
"""
import os
import shutil

import cv2
import numpy as np
import pytest

from revo_tpu.io import native_loader as jloader
from revo_tpu_torch.io import _native, native_loader


pytestmark = pytest.mark.skipif(
    not native_loader.native_available(),
    reason="native IO library unavailable",
)


@pytest.fixture
def tum_frames(tmp_path):
    """Write TUM-style rgb (8-bit color) + depth (16-bit) PNG pairs."""
    rng = np.random.default_rng(0)
    rgb_paths, depth_paths, rgbs, depths = [], [], [], []
    for i in range(5):
        rgb = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
        depth = rng.integers(0, 30000, size=(48, 64), dtype=np.uint16)
        rp = os.path.join(tmp_path, f"rgb_{i}.png")
        dp = os.path.join(tmp_path, f"depth_{i}.png")
        cv2.imwrite(rp, rgb)  # cv2 writes BGR channel order
        cv2.imwrite(dp, depth)
        rgb_paths.append(rp)
        depth_paths.append(dp)
        rgbs.append(rgb)
        depths.append(depth)
    return rgb_paths, depth_paths, rgbs, depths


class TestDecode:
    def test_gray_matches_cv2(self, tum_frames):
        rgb_paths, _, rgbs, _ = tum_frames
        for rp, bgr in zip(rgb_paths, rgbs):
            want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
            got = native_loader.load_gray(rp)
            assert got.shape == want.shape
            # identical fixed-point weights -> at most off-by-one from
            # rounding-order differences
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_depth16_exact(self, tum_frames):
        _, depth_paths, _, depths = tum_frames
        for dp, want in zip(depth_paths, depths):
            got = native_loader.load_depth16(dp)
            np.testing.assert_array_equal(got, want)

    def test_png_info(self, tum_frames):
        rgb_paths, depth_paths, _, _ = tum_frames
        w, h, is16 = native_loader.png_info(rgb_paths[0])
        assert (w, h, is16) == (64, 48, False)
        w, h, is16 = native_loader.png_info(depth_paths[0])
        assert (w, h, is16) == (64, 48, True)

    def test_missing_file(self):
        with pytest.raises(IOError):
            native_loader.png_info("/nonexistent.png")


class TestPrefetcher:
    def test_ordered_delivery(self, tum_frames):
        rgb_paths, depth_paths, rgbs, depths = tum_frames
        with native_loader.NativePrefetcher(
            rgb_paths, depth_paths, (48, 64), n_threads=3, window=3
        ) as pf:
            for i in range(5):
                gray, depth = pf.get(i)
                want_gray = cv2.cvtColor(rgbs[i], cv2.COLOR_BGR2GRAY)
                assert np.abs(
                    gray.astype(int) - want_gray.astype(int)
                ).max() <= 1
                np.testing.assert_array_equal(depth, depths[i])

    def test_decode_failure_surfaces(self, tum_frames, tmp_path):
        rgb_paths, depth_paths, _, _ = tum_frames
        bad = os.path.join(tmp_path, "bad.png")
        open(bad, "wb").write(b"not a png")
        with native_loader.NativePrefetcher(
            [rgb_paths[0], bad], [depth_paths[0], depth_paths[1]], (48, 64)
        ) as pf:
            pf.get(0)
            with pytest.raises(IOError):
                pf.get(1)


def test_decodes_equal_the_jax_binding(tum_frames):
    if not jloader.native_available():
        pytest.skip("the JAX package's IO library is unavailable")
    rgb_paths, depth_paths, _, _ = tum_frames
    for rp, dp in zip(rgb_paths, depth_paths):
        assert native_loader.png_info(rp) == jloader.png_info(rp)
        assert native_loader.load_gray(rp).tobytes() == jloader.load_gray(rp).tobytes()
        assert native_loader.load_depth16(dp).tobytes() == jloader.load_depth16(dp).tobytes()
    with native_loader.NativePrefetcher(rgb_paths, depth_paths, (48, 64)) as pt, \
            jloader.NativePrefetcher(rgb_paths, depth_paths, (48, 64)) as pj:
        for i in range(len(rgb_paths)):
            (g_t, d_t), (g_j, d_j) = pt.get(i), pj.get(i)
            assert g_t.tobytes() == g_j.tobytes() and d_t.tobytes() == d_j.tobytes()


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader with its per-process outcome dropped, and restored after."""
    saved = dict(_native._loaded), dict(_native._reasons)
    _native.forget()
    yield monkeypatch
    _native.forget()
    _native._loaded.update(saved[0])
    _native._reasons.update(saved[1])


def test_missing_tracked_library_is_built(fresh_loader, tmp_path, tum_frames):
    """Point the loader at a directory without the tracked file: it compiles
    native/revo_io.cpp into build/revo_tpu_torch/native/ and the binding
    decodes through that build; native/ itself is not written to."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    if not os.path.exists("/usr/include/png.h"):
        pytest.skip("no libpng headers (png.h) to build revo_io.cpp with")
    tracked_before = sorted(os.listdir(_native.SOURCE_DIR))
    fresh_loader.setattr(_native, "TRACKED_DIR", tmp_path)
    assert native_loader.native_available(), _native.why_unavailable("io")
    built = _native.loaded_path("io")
    assert os.path.dirname(built) == str(_native.BUILD_DIR)
    assert str(_native.BUILD_DIR).endswith(os.path.join("build", "revo_tpu_torch", "native"))
    assert os.path.exists(built) and _native.why_unavailable("io") is None
    rgb_paths, depth_paths, _, depths = tum_frames
    np.testing.assert_array_equal(native_loader.load_depth16(depth_paths[0]), depths[0])
    assert sorted(os.listdir(_native.SOURCE_DIR)) == tracked_before
    # An unchanged source loads the existing build.
    _native.forget("io")
    stamp = os.path.getmtime(built)
    assert native_loader.native_available() and os.path.getmtime(built) == stamp


def test_unbuildable_library_is_unavailable_with_a_reason(fresh_loader, tmp_path):
    """Neither a tracked file nor a source: unavailable, the reason kept as
    a string that names both attempts; the binding's entry points raise it."""
    fresh_loader.setattr(_native, "TRACKED_DIR", tmp_path)
    fresh_loader.setattr(_native, "SOURCE_DIR", tmp_path)
    assert not native_loader.native_available()
    why = native_loader.why_unavailable()
    assert "tracked library" in why and "build" in why and "revo_io.cpp" in why
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.load_gray("x.png")
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.NativePrefetcher([], [], (48, 64))
    assert _native.loaded_path("io") is None


def test_tracked_library_that_does_not_load_is_rebuilt(fresh_loader, tmp_path):
    """A tracked file that dlopen refuses (here: not an ELF file, as a
    library linked on another machine fails on missing dependencies) takes
    the build path too."""
    if shutil.which("g++") is None or not os.path.exists("/usr/include/png.h"):
        pytest.skip("no g++ or no libpng headers to build revo_io.cpp with")
    (tmp_path / "librevo_io.so").write_bytes(b"not a shared object")
    fresh_loader.setattr(_native, "TRACKED_DIR", tmp_path)
    assert native_loader.native_available(), _native.why_unavailable("io")
    assert os.path.dirname(_native.loaded_path("io")) == str(_native.BUILD_DIR)
