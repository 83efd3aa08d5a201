"""The port's capacity calibration, RPE, TUM pose files and ``run`` entry
point against the JAX package's, at 160x120 on the CPU.

Tolerances: calibrated capacities equal; RPE within 1e-12 relative; a TUM
file read back by either package gives the same poses bit for bit; the pose
file that ``python -m revo_tpu_torch.run --synthetic 12 --device cpu``
writes within 1e-4 of the one ``revo_tpu.run --synthetic 12 --cpu`` writes
on the same settings.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import autotune as jautotune
from revo_tpu import lie as jlie
from revo_tpu import run as jrun
from revo_tpu.eval import relative_pose_error as j_rpe
from revo_tpu.io import tum as jtum
from revo_tpu_torch import autotune, convert, lie, run
from revo_tpu_torch.eval import relative_pose_error as t_rpe
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.io import tum

from test_solver import small_cfg
from test_torch_vo import pan_sequence

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("margin", [0.65, 1.15])
def test_calibrate_capacities_matches_jax(margin):
    cfg = small_cfg()
    frames, _ = pan_sequence(cfg.camera, 8)
    grays, depths = [frames[0][0], frames[7][0]], [frames[0][1], frames[7][1]]
    want = jautotune.calibrate_capacities(cfg, grays, depths, margin=margin)
    got = autotune.calibrate_capacities(convert.config_from_jax(cfg), grays, depths,
                                        margin=margin, device="cpu")
    assert got.pyramid.edge_capacity == want.pyramid.edge_capacity
    assert got == convert.config_from_jax(want)
    counts = [[1000, 1200], [300], []]
    assert autotune.fit_capacities(counts, 1.15, 256, 512) == jautotune.fit_capacities(
        counts, 1.15, 256, 512)


def _poses(n, seed):
    xs = np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32) * 0.3
    return lie.matrix_from_rt(*lie.exp_se3(torch.from_numpy(xs))).numpy()


def test_relative_pose_error_matches_jax():
    est, gt = _poses(12, 0).astype(np.float64), _poses(12, 1).astype(np.float64)
    for delta in (1, 3):
        a, b = t_rpe(est, gt, delta), j_rpe(est, gt, delta)
        assert a.trans_rmse == pytest.approx(b.trans_rmse, rel=1e-12)
        assert a.rot_rmse_deg == pytest.approx(b.rot_rmse_deg, rel=1e-12)


def test_tum_round_trip_matches_jax(tmp_path):
    poses = _poses(7, 2)
    ts = np.arange(7) * 0.033 + 1305031102.0
    qs = lie.quaternion_from_matrix(torch.from_numpy(poses[:, :3, :3])).numpy()
    np.testing.assert_allclose(
        qs, np.asarray(jlie.quaternion_from_matrix(jnp.asarray(poses[:, :3, :3]))),
        rtol=0, atol=1e-7)
    path = str(tmp_path / "poses.txt")
    tum.write_tum_trajectory(path, ts, poses[:, :3, 3], qs)
    ts_t, p_t = tum.read_tum_trajectory(path)
    ts_j, p_j = jtum.read_tum_trajectory(path)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(p_t, np.asarray(p_j))
    np.testing.assert_allclose(p_t, poses, atol=1e-5)
    assignments = tmp_path / "associate.txt"
    assignments.write_text("# rgb depth\n1.0 rgb/1.png 1.01 depth/1.png\n2.0 a b\n")
    assert tum.load_associations(str(tmp_path)) == [
        tum.Association(1.0, "rgb/1.png", 1.01, "depth/1.png")]


def _settings(tmp_path):
    """Settings files both packages read: the 160x120 camera of small_cfg."""
    cam = small_cfg().camera
    settings = tmp_path / "settings.yaml"
    settings.write_text("%YAML:1.0\nDO_OUTPUT_POSES: 1\n")
    dataset = tmp_path / "camera.yaml"
    dataset.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\nCamera.cx: {cam.cx}\n"
        f"Camera.cy: {cam.cy}\nCamera.width: {cam.width}\nCamera.height: {cam.height}\n"
    )
    return [str(settings), str(dataset)]


def test_run_synthetic_matches_jax(tmp_path):
    """The port's CLI in its own process against revo_tpu.run's main (the
    code of ``python -m revo_tpu.run``), with capacities calibrated on the
    first 2 frames on both sides.  Seed 2: at this size seed 0's frame 1 is
    a knife edge, where JAX's own eager and jitted level-2 LM stop 3e-4 m
    apart (ROADMAP Queue 3)."""
    args = _settings(tmp_path) + ["--synthetic", "12", "--seed", "2", "--auto-capacity", "2"]
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "revo_tpu_torch.run", *args, "--device", "cpu",
         "--out", str(out_t)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Frames Tracked: 12" in proc.stdout
    assert jrun.main(args + ["--cpu", "--out", str(out_j)]) == 0
    ts_t, p_t = tum.read_tum_trajectory(str(out_t / "poses_synthetic.txt"))
    ts_j, p_j = tum.read_tum_trajectory(str(out_j / "poses_synthetic.txt"))
    assert len(ts_t) == 12
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-4)


def test_run_dataset_matches_jax(tmp_path, capsys):
    """Dataset mode on a TUM-layout sequence written as PNGs (raw rgb.txt /
    depth.txt, so the port generates associate.txt) with --gt: the port's
    main against revo_tpu.run's on the same files."""
    import cv2

    cam = small_cfg().camera
    ds = tmp_path / "seq"
    (ds / "rgb").mkdir(parents=True)
    (ds / "depth").mkdir()
    rgb_lines, depth_lines, gts, stamps = [], [], [], []
    for i, (gray, depth, T, ts) in enumerate(
        tsyn.render_sequence(tsyn.SyntheticScene(), cam, 8, seed=7)
    ):
        cv2.imwrite(str(ds / f"rgb/{i}.png"), np.stack([gray] * 3, -1).astype(np.uint8))
        cv2.imwrite(str(ds / f"depth/{i}.png"), (depth * 5000).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{i}.png")
        depth_lines.append(f"{ts:.6f} depth/{i}.png")
        gts.append(T)
        stamps.append(ts)
    (ds / "rgb.txt").write_text("\n".join(rgb_lines))
    (ds / "depth.txt").write_text("\n".join(depth_lines))
    gt = np.stack(gts)
    qs = lie.quaternion_from_matrix(torch.from_numpy(gt[:, :3, :3])).numpy()
    tum.write_tum_trajectory(str(ds / "groundtruth.txt"), stamps, gt[:, :3, 3], qs)
    settings, camera = _settings(tmp_path)
    with open(camera, "a") as f:
        f.write(f'MainFolder: "{tmp_path}/"\nDatasets: "seq"\n')
    args = [settings, camera, "--gt", "groundtruth.txt", "--auto-capacity", "2"]
    assert run.main(args + ["--device", "cpu", "--out", str(tmp_path / "torch")]) == 0
    out = capsys.readouterr().out
    assert "generated associate.txt: 8 pairs" in out and "ATE-RMSE vs GT" in out
    assert jrun.main(args + ["--cpu", "--out", str(tmp_path / "jax")]) == 0
    _, p_t = tum.read_tum_trajectory(str(tmp_path / "torch" / "poses_seq.txt"))
    _, p_j = tum.read_tum_trajectory(str(tmp_path / "jax" / "poses_seq.txt"))
    assert p_t.shape == (8, 4, 4)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("flag, item", [
    (["--close-loops"], "P12"),
    (["--windowed-ba"], "P12"),
    (["--live-view"], "P11"),
    (["--record", "rec"], "P11"),
    (["--input-type", "2"], "P11"),
])
def test_unported_flag_exits_nonzero(flag, item, capsys):
    with pytest.raises(SystemExit) as exc:
        run.main(["--synthetic", "2", "--device", "cpu", *flag])
    assert exc.value.code != 0
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_cuda_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--synthetic", "2", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.calibrate_capacities(
            convert.config_from_jax(small_cfg()),
            [np.zeros((120, 160), np.float32)], [np.zeros((120, 160), np.float32)],
            device="cuda")
