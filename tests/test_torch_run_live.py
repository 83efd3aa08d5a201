"""``python -m revo_tpu_torch.run`` in live mode (INPUT_TYPE 1/2/3) against
``revo_tpu.run``, through the V4L2 engine's replay shim at 160x120 on the
CPU: tests/test_sensors.py:255-359 for the port's CLI, and the same frames
through both CLIs.

Tolerances: poses_live.txt of the two packages within 5e-5 m and 5e-5 rad;
the capture ``--record`` writes byte-equal between the packages, file by
file (which pins the reference's saturated depth: the live path hands the
recorder raw uint16 depth, and the recorder scales it by 5000 again).

Where both bindings load the same library file they share one replay
registry, so each package gets device names and session files of its own.
"""
import os

import numpy as np
import pytest
import torch

from revo_tpu import run as jrun
from revo_tpu.io import sensors as jsensors
from revo_tpu_torch import run
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.io import sensors, tum
from revo_tpu_torch.io import synthetic as tsyn

from test_solver import small_cfg
from test_torch_vo import assert_poses_close, pan_sequence

torch.set_num_threads(1)

LIVE_TOL = 5e-5  # metres and radians, port against JAX

pytestmark = pytest.mark.skipif(
    not sensors.available(), reason="librevo_sensor.so unavailable"
)


@pytest.fixture(autouse=True)
def _real_devices_after():
    yield
    sensors.use_real_devices()
    if jsensors.available():
        jsensors.use_real_devices()


def _config_files(tmp_path):
    """The reference's split: INPUT_TYPE in the settings file, the camera
    calibration in the dataset / camera file."""
    cam = small_cfg().camera
    settings = tmp_path / "settings.yaml"
    settings.write_text("%YAML:1.0\nINPUT_TYPE: 3\nPYR_MIN_LVL: 2\nPYR_MAX_LVL: 0\n")
    camfile = tmp_path / "camera.yaml"
    camfile.write_text(
        "%YAML:1.0\n"
        f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
        f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\nCamera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
    )
    return [str(settings), str(camfile)]


def _sessions(mod, folder, frames):
    """``frames`` [(gray f32, depth f32 metres, ts)] as a YUYV and a Z16
    session written by package ``mod``; returns the replay flags."""
    os.makedirs(folder, exist_ok=True)
    h, w = frames[0][0].shape
    stamps = [ts for _, _, ts in frames]
    cpath, dpath = os.path.join(folder, "color.rvs"), os.path.join(folder, "depth.rvs")
    mod.write_session(
        cpath, [mod.encode_yuyv(np.clip(g, 0, 255).astype(np.uint8)) for g, _, _ in frames],
        stamps, w, h, mod.YUYV)
    mod.write_session(
        dpath, [(d * 5000.0).astype(np.uint16).astype("<u2").tobytes() for _, d, _ in frames],
        stamps, w, h, mod.Z16)
    tag = os.path.basename(folder)
    return ["--color-dev", f"/dev/video_{tag}_c", "--depth-dev", f"/dev/video_{tag}_d",
            "--replay-color", cpath, "--replay-depth", dpath]


@pytest.fixture(scope="module")
def handheld():
    return [(g, d, ts) for g, d, _, ts in
            tsyn.render_sequence(tsyn.SyntheticScene(), small_cfg().camera, 8, seed=5)]


@pytest.fixture(scope="module")
def live_runs(tmp_path_factory, handheld):
    """Both CLIs over the same 8 frames, 6 of them tracked and recorded:
    (tmp dir, the port's stdout)."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("live")
    files = _config_files(tmp)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = run.main(files + _sessions(sensors, str(tmp / "torch"), handheld) + [
            "--out", str(tmp / "out_torch"), "--max-frames", "6",
            "--record", str(tmp / "rec_torch"), "--device", "cpu"])
    sensors.use_real_devices()
    assert rc == 0
    if jsensors.available():
        assert jrun.main(files + _sessions(jsensors, str(tmp / "jax"), handheld) + [
            "--out", str(tmp / "out_jax"), "--max-frames", "6",
            "--record", str(tmp / "rec_jax"), "--cpu"]) == 0
        jsensors.use_real_devices()
    return tmp, said.getvalue()


def test_run_cli_live_input_type(live_runs, handheld):
    """The reference's INPUT_TYPE live entry (iowrapperRGBD.h:56-102) through
    the port's run: the settings yaml selects INPUT_TYPE=3, the engine is
    routed at recorded sessions, poses_live.txt comes out with the sessions'
    stamps, and the stream is re-recorded as a TUM capture (DO_RECORD_IMAGES)."""
    tmp, said = live_runs
    assert "live sensor: astra (INPUT_TYPE=3) 160x120" in said
    assert "Frames Tracked: 6" in said
    stamps, poses = tum.read_tum_trajectory(str(tmp / "out_torch" / "poses_live.txt"))
    assert len(stamps) == 6
    np.testing.assert_allclose(stamps, [ts for _, _, ts in handheld[:6]], rtol=0, atol=1e-6)
    assert np.isfinite(poses).all() and np.linalg.norm(poses[-1, :3, 3]) > 1e-3
    assert len((tmp / "rec_torch" / "associate.txt").read_text().splitlines()) == 6
    assert not (tmp / "out_torch" / "live").exists()  # no --live-view, no viewer


def test_live_poses_match_jax(live_runs):
    tmp, _ = live_runs
    if not jsensors.available():
        pytest.skip("the JAX package's sensor library is unavailable")
    ts_t, p_t = tum.read_tum_trajectory(str(tmp / "out_torch" / "poses_live.txt"))
    ts_j, p_j = tum.read_tum_trajectory(str(tmp / "out_jax" / "poses_live.txt"))
    np.testing.assert_array_equal(ts_t, ts_j)
    assert_poses_close(p_t, p_j, tol=LIVE_TOL)


def test_recorded_capture_byte_equal_and_saturated(live_runs, handheld):
    """The two packages' captures hold the same files with the same bytes.
    The depth PNGs are saturated: the live path hands the recorder the
    sensor's raw uint16 depth and ``TUMRecorder.add`` multiplies by 5000 and
    clips to 65535, a fault of the reference that the port mirrors."""
    import cv2

    tmp, _ = live_runs
    if not jsensors.available():
        pytest.skip("the JAX package's sensor library is unavailable")
    names = []
    for root, _, files in os.walk(tmp / "rec_torch"):
        names += [os.path.relpath(os.path.join(root, f), tmp / "rec_torch") for f in files]
    assert len(names) == 13  # associate.txt + 6 rgb + 6 depth
    for name in names:
        assert (tmp / "rec_torch" / name).read_bytes() == (tmp / "rec_jax" / name).read_bytes(), name
    first = sorted(n for n in names if n.startswith("depth"))[0]
    depth = cv2.imread(str(tmp / "rec_torch" / first), cv2.IMREAD_UNCHANGED)
    raw = (handheld[0][1] * 5000.0).astype(np.uint16)
    assert depth.dtype == np.uint16
    np.testing.assert_array_equal(depth, np.clip(raw.astype(np.float64) * 5000.0, 0, 65535)
                                  .astype(np.uint16))
    assert (depth[raw > 13] == 65535).all() and (raw > 13).mean() > 0.9
    gray = cv2.imread(str(tmp / "rec_torch" / first.replace("depth", "rgb")))
    np.testing.assert_array_equal(gray[..., 0], np.clip(handheld[0][0], 0, 255).astype(np.uint8))


def test_live_cli_with_viewer_ba_and_ply(tmp_path, capsys):
    """--live-view --export-ply --windowed-ba --close-loops on the 20-frame
    pan through the live CLI: the pan promotes, so BA refines >= 2
    keyframes; the viewer's files and the PLY files exist and the viewer
    logged no error; poses equal the same run without the post-run flags."""
    cam = small_cfg().camera
    frames, gt = pan_sequence(cam, 20)
    files = _config_files(tmp_path)
    replay = _sessions(sensors, str(tmp_path / "pan"), frames)
    out = tmp_path / "out"
    assert run.main(files + replay + [
        "--out", str(out), "--max-frames", "20", "--close-loops", "--windowed-ba",
        "--export-ply", "--live-view", "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "Frames Tracked: 20" in said and "Live view written to" in said
    ba = [ln for ln in said.splitlines() if "windowed BA: refined" in ln]
    assert ba and int(ba[0].split("refined")[1].split()[0]) >= 2, said
    live = out / "live"
    assert not (live / "viewer_errors.log").exists(), (live / "viewer_errors.log").read_text()
    for name in ("index.html", "trajectory.png", "overlay.png", "map.png"):
        assert (live / name).stat().st_size > 0, name
    for name in ("map_cloud.ply", "map_keyframes.ply", "trajectory.ply"):
        assert (out / name).stat().st_size > 0, name
    _, poses = tum.read_tum_trajectory(str(out / "poses_live.txt"))
    assert absolute_trajectory_error(poses.astype(np.float64), gt).rmse < 0.01
    # The viewer and the post-run flags change no pose of the run itself.
    plain = tmp_path / "plain"
    assert run.main(files + replay + ["--out", str(plain), "--device", "cpu"]) == 0
    _, poses_plain = tum.read_tum_trajectory(str(plain / "poses_live.txt"))
    np.testing.assert_array_equal(poses, poses_plain)


def test_input_type_flag_overrides_settings(tmp_path, capsys, handheld):
    """--input-type wins over the settings yaml's INPUT_TYPE; the Astra Pro
    profile (1) wants MJPEG colour, so a YUYV session is refused at open,
    as the JAX CLI refuses it."""
    files = _config_files(tmp_path)
    replay = _sessions(sensors, str(tmp_path / "s"), handheld[:2])
    with pytest.raises(RuntimeError, match="sensor open failed \\(astra_pro"):
        run.main(files + replay + ["--input-type", "1", "--out", str(tmp_path / "o"),
                                   "--device", "cpu"])
    sensors.use_real_devices()
    assert run.main(files + replay + ["--input-type", "2", "--max-frames", "2",
                                      "--out", str(tmp_path / "o2"), "--device", "cpu"]) == 0
    assert "live sensor: realsense (INPUT_TYPE=2)" in capsys.readouterr().out
