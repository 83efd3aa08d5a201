"""The port's ``run`` entry point with ``--windowed-ba``, ``--close-loops``
and ``--export-ply`` against revo_tpu.run's, at 160x120 on the CPU.

Tolerances: refined and re-anchored poses within 1e-4 of the JAX package's;
the same report lines; the three PLY files present, with the same counts,
and the exported trajectory within 1e-4.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from revo_tpu import run as jrun
from revo_tpu import system as jsystem
from revo_tpu_torch import convert, lie, run, system
from revo_tpu_torch.io import tum

from test_solver import small_cfg
from test_torch_run import _settings
from test_torch_vo import pan_sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import read_ply  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loop_systems():
    """Both packages' VOSystem holding the four loop keyframes of
    tests/test_loopclosure.py and an 8-frame pose graph hanging off them
    (tests/test_torch_run.py::test_maybe_close_loops_reanchors_the_run)."""
    from test_loopclosure import _loop_keyframes

    cfg, kfs, _, drifted = _loop_keyframes()
    tcfg = convert.config_from_jax(cfg)
    tk = [convert.keyframe_from_numpy(jax.tree.map(np.asarray, k), device="cpu") for k in kfs]
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.01, 0.0, 0.0]
    vj, vt = jsystem.VOSystem(cfg), system.VOSystem(tcfg, device="cpu")
    for vo, keyframes, node_cls in ((vj, kfs, jsystem.PoseNode), (vt, tk, system.PoseNode)):
        vo.kf_history = list(enumerate(keyframes))
        vo.n_keyframes = 4
        vo.pose_graph = [
            node_cls(T_kf_curr=rel, T_w_kf=drifted[i // 2], timestamp=float(i), kf_ordinal=i // 2)
            for i in range(8)
        ]
    return vj, vt, np.stack([n.T_w_curr for n in vt.pose_graph])


@pytest.mark.parametrize("windowed_ba, close_loops", [(True, True), (True, False), (False, False)])
def test_post_run_refinement_matches_jax(loop_systems, windowed_ba, close_loops, capsys):
    """With both flags loop closure runs first, its edge (0, 3) enters the
    BA as a residual pair of weight 2 and its corrected poses seed it."""
    vj, vt, poses = loop_systems
    got = run._post_run_refinement(vt, poses, windowed_ba, close_loops)
    out_t = capsys.readouterr().out
    want = jrun._post_run_refinement(vj, poses, windowed_ba, close_loops)
    out_j = capsys.readouterr().out
    assert out_t.replace("[revo_tpu_torch]", "") == out_j.replace("[revo_tpu]", "")
    assert got.shape == (8, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if not windowed_ba:
        np.testing.assert_array_equal(got, poses)
        return
    assert "windowed BA: refined 4 keyframes" in out_t
    assert ("1 loop edge(s) as residual pairs" in out_t) == close_loops
    np.testing.assert_array_equal(got[:2], poses[:2])  # the gauge keyframe stays
    assert np.abs(got - poses).max() > 5e-3


def test_run_dataset_windowed_ba_export_ply_matches_jax(tmp_path, capsys):
    """Dataset mode over the 20-frame pan written as PNGs (it promotes
    twice, so three keyframes are retained): ``--close-loops --windowed-ba
    --export-ply`` in both packages."""
    import cv2

    cam = small_cfg().camera
    frames, gt = pan_sequence(cam, 20)
    ds = tmp_path / "pan"
    (ds / "rgb").mkdir(parents=True)
    (ds / "depth").mkdir()
    lines = []
    for i, (gray, depth, ts) in enumerate(frames):
        cv2.imwrite(str(ds / f"rgb/{i}.png"), np.stack([gray] * 3, -1).astype(np.uint8))
        cv2.imwrite(str(ds / f"depth/{i}.png"), (depth * 5000).astype(np.uint16))
        lines.append(f"{ts:.6f} rgb/{i}.png {ts:.6f} depth/{i}.png")
    (ds / "associate.txt").write_text("\n".join(lines))
    qs = lie.quaternion_from_matrix(torch.from_numpy(gt[:, :3, :3])).numpy()
    tum.write_tum_trajectory(str(ds / "groundtruth.txt"), [f[2] for f in frames], gt[:, :3, 3], qs)
    settings, camera = _settings(tmp_path)
    with open(camera, "a") as f:
        f.write(f'MainFolder: "{tmp_path}/"\nDatasets: "pan"\n')
    args = [settings, camera, "--gt", "groundtruth.txt", "--close-loops", "--windowed-ba",
            "--export-ply"]
    assert run.main(args + ["--device", "cpu", "--out", str(tmp_path / "torch")]) == 0
    out_t = capsys.readouterr().out
    assert jrun.main(args + ["--cpu", "--out", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out

    def said(out, tag, what):
        found = [ln.replace(tag, "") for ln in out.splitlines() if what in ln]
        assert len(found) == 1, out
        return found[0]

    for what in ("Keyframes Tracked", "loop closure:", "windowed BA:"):
        assert said(out_t, "[revo_tpu_torch] ", what) == said(out_j, "[revo_tpu] ", what)
    assert "Keyframes Tracked: 3" in out_t and "refined 3 keyframes" in out_t
    assert "PLY model written" in out_t and "ATE-RMSE vs GT" in out_t
    for name in ("map_cloud.ply", "map_keyframes.ply", "trajectory.ply"):
        c_t, v_t = read_ply(tmp_path / "torch" / name)
        c_j, v_j = read_ply(tmp_path / "jax" / name)
        assert c_t == c_j and c_t["vertex"] > 0, name
        if name != "map_cloud.ply":  # the cloud's points follow from equal edges and poses
            np.testing.assert_allclose(v_t[:, :3], v_j[:, :3], rtol=0, atol=1e-4)
    # The exported trajectory is the refined one; the pose file holds the run's own.
    _, traj = read_ply(tmp_path / "torch" / "trajectory.ply")
    _, p_t = tum.read_tum_trajectory(str(tmp_path / "torch" / "poses_pan.txt"))
    _, p_j = tum.read_tum_trajectory(str(tmp_path / "jax" / "poses_pan.txt"))
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-4)
    assert traj.shape == (20, 3) and np.abs(traj - p_t[:, :3, 3]).max() > 1e-6


def test_run_synthetic_flags_match_jax(tmp_path, capsys):
    """``--synthetic N`` with the new flags no longer exits 2, in both
    packages: a short handheld sequence retains one keyframe, so both
    refinements say they skip, and the PLY files are written from the
    stored keyframe images; the same lines, poses within 1e-4."""
    args = _settings(tmp_path) + ["--synthetic", "4", "--seed", "2", "--windowed-ba",
                                  "--close-loops", "--export-ply"]
    assert run.main(args + ["--device", "cpu", "--out", str(tmp_path / "torch")]) == 0
    out_t = capsys.readouterr().out
    assert jrun.main(args + ["--cpu", "--out", str(tmp_path / "jax")]) == 0
    out_j = capsys.readouterr().out
    for line in ("windowed BA: <2 keyframes retained; skipping",
                 "loop closure: <3 keyframes retained; skipping"):
        assert line in out_t and line in out_j
    _, p_t = tum.read_tum_trajectory(str(tmp_path / "torch" / "poses_synthetic.txt"))
    _, p_j = tum.read_tum_trajectory(str(tmp_path / "jax" / "poses_synthetic.txt"))
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-4)
    counts, verts = read_ply(tmp_path / "torch" / "map_cloud.ply")
    assert counts["vertex"] > 100 and np.isfinite(verts).all()
    assert counts == read_ply(tmp_path / "jax" / "map_cloud.ply")[0]
    for name, want in (("map_keyframes.ply", {"vertex": 5, "edge": 8}),
                       ("trajectory.ply", {"vertex": 4, "edge": 3})):
        assert read_ply(tmp_path / "torch" / name)[0] == want
        assert read_ply(tmp_path / "jax" / name)[0] == want
