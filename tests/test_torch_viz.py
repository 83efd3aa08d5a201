"""The port's views (revo_tpu_torch/viz: plot, map3d, debug, live) against
the JAX package's on equal inputs, on the CPU.

The PNG files the two packages write from equal inputs decode to equal
images; ``reprojection_overlay`` on a keyframe and frame carried over by
``convert`` equals JAX's array; the live viewer renders on its thread while a
VOSystem runs, logs no error, and changes no pose.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import tracker as jtracker
from revo_tpu.viz import debug as jdebug
from revo_tpu_torch import convert, lie, system, viz
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.viz import debug, live

from test_solver import small_cfg

torch.set_num_threads(1)


def _poses(n, seed, scale=0.05):
    xi = np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32) * scale
    step = lie.matrix_from_rt(*lie.exp_se3(torch.from_numpy(xi))).numpy()
    out, T = [], np.eye(4, dtype=np.float32)
    for s in step:
        T = T @ s
        out.append(T.copy())
    return np.stack(out)


def _read(path):
    import matplotlib.image

    img = matplotlib.image.imread(str(path))
    assert img.size > 0 and img.std() > 0
    return img


@pytest.mark.parametrize("with_gt", [False, True])
def test_plot_trajectory_matches_jax(tmp_path, with_gt):
    pytest.importorskip("matplotlib")
    from revo_tpu.viz import plot as jplot
    from revo_tpu_torch.viz import plot

    est, gt = _poses(15, 0), (_poses(15, 1) if with_gt else None)
    plot.plot_trajectory(str(tmp_path / "t.png"), est, gt, title="parity")
    jplot.plot_trajectory(str(tmp_path / "j.png"), est, gt, title="parity")
    np.testing.assert_array_equal(_read(tmp_path / "t.png"), _read(tmp_path / "j.png"))


def test_plot_error_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from revo_tpu.viz import plot as jplot
    from revo_tpu_torch.viz import plot

    gt = _poses(15, 1)
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(2).normal(scale=3e-3, size=(15, 3)).astype(np.float32)
    plot.plot_error(str(tmp_path / "t.png"), est, gt)
    jplot.plot_error(str(tmp_path / "j.png"), est, gt)
    np.testing.assert_array_equal(_read(tmp_path / "t.png"), _read(tmp_path / "j.png"))


def test_render_map_png_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from revo_tpu.viz import map3d as jmap3d
    from revo_tpu_torch.viz import map3d

    rng = np.random.default_rng(3)
    traj = _poses(12, 4, scale=0.03)
    kf_poses = traj[::4]
    clouds = [(rng.normal(size=(200, 3)) * 0.4 + [0, 0, 2.0] + T[:3, 3], rng.random((200, 3)))
              for T in kf_poses]
    for mod, name in ((map3d, "t.png"), (jmap3d, "j.png")):
        mod.render_map_png(str(tmp_path / name), clouds, kf_poses, traj, traj[-1], title="m")
        mod.render_map_png(str(tmp_path / ("e" + name)), [], np.eye(4)[None], traj[:0],
                           np.eye(4))
    np.testing.assert_array_equal(_read(tmp_path / "t.png"), _read(tmp_path / "j.png"))
    np.testing.assert_array_equal(_read(tmp_path / "et.png"), _read(tmp_path / "ej.png"))
    np.testing.assert_array_equal(map3d._frustum_corners(traj[3]), jmap3d._frustum_corners(traj[3]))
    np.testing.assert_array_equal(map3d._follow_view(traj[3]), jmap3d._follow_view(traj[3]))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("lvl", [0, 1])
def test_reprojection_overlay_matches_jax(tmp_path, lvl):
    """JAX's frame, keyframe and tracked pose through both overlays: equal
    (H, W, 3) uint8 arrays, with pixels painted; the PNG, where OpenCV
    imports, holds the image in BGR."""
    cfg = small_cfg()
    tcfg = convert.config_from_jax(cfg)
    seq = list(tsyn.render_sequence(tsyn.SyntheticScene(), tcfg.camera, 3, seed=4))
    fj = [jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg) for g, d, _, _ in seq]
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    res = jtracker.track_frames(kj, fj[2], jnp.eye(3), jnp.zeros(3), cfg)
    kt = convert.keyframe_from_numpy(_np_tree(kj), device="cpu")
    ft = convert.frame_from_numpy(_np_tree(fj[2]), device="cpu")
    want = jdebug.reprojection_overlay(kj, fj[2], res.R, res.t, cfg, lvl=lvl)
    png = str(tmp_path / "overlay.png")
    got = debug.reprojection_overlay(kt, ft, torch.from_numpy(np.array(res.R)),
                                     torch.from_numpy(np.array(res.t)), tcfg, lvl=lvl,
                                     out_png=png)
    cam = tcfg.camera_pyramid()[lvl]
    assert got.shape == (cam.height, cam.width, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] != got[..., 1]).sum() > 100  # painted pixels are not gray
    # numpy poses are taken as they are
    np.testing.assert_array_equal(
        debug.reprojection_overlay(kt, ft, np.asarray(res.R), np.asarray(res.t), tcfg, lvl=lvl),
        want)
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(cv2.imread(png)[..., ::-1], got)


def test_viz_exports_match_jax():
    import revo_tpu.viz as jviz

    assert sorted(viz.__all__) == sorted(jviz.__all__)
    assert all(callable(getattr(viz, name)) for name in viz.__all__)


def _run_with(viewer, cfg, frames):
    vo = system.VOSystem(cfg, device="cpu")
    poses, _, _ = vo.run(iter(frames), viewer=viewer)
    return vo, poses


def test_live_viewer_renders_during_run(tmp_path):
    """tests/test_scenes.py:445-485 for the port: the headless viewer
    renders trajectory + reprojection overlay + 3-D map + index.html on its
    background thread while the run progresses, logs no error, and the run's
    poses equal the run without a viewer bit for bit."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("cv2")
    cfg = convert.config_from_jax(small_cfg())
    # --live-view runs keep keyframe images for the colored map pane
    # (run.py sets this; retained keyframes are pruned otherwise).
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, store_kf_images=True))
    frames = [(g, d, ts) for g, d, _, ts in
              tsyn.render_sequence(tsyn.box_scene(), cfg.camera, 8, seed=1)]
    viewer = live.LiveViewer(str(tmp_path), every=2)
    _, poses = _run_with(viewer, cfg, frames)
    viewer.close()
    out = tmp_path / "live"
    assert not (out / "viewer_errors.log").exists(), (out / "viewer_errors.log").read_text()
    for name in ("index.html", "trajectory.png", "overlay.png", "map.png"):
        assert (out / name).stat().st_size > 0, name
    html = (out / "index.html").read_text()
    assert "map.png" in html and "frame " in html and "keyframes 1" in html
    _, poses_plain = _run_with(None, cfg, frames)
    np.testing.assert_array_equal(poses, poses_plain)


def test_live_viewer_snapshot_is_host_only(tmp_path, monkeypatch):
    """What crosses to the render thread holds no tensor; a keyframe's
    cloud crosses once; frames that are not due cost no copy; a full queue
    drops the frame."""
    cfg = convert.config_from_jax(small_cfg())
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, store_kf_images=True))
    frames = [(g, d, ts) for g, d, _, ts in
              tsyn.render_sequence(tsyn.SyntheticScene(), cfg.camera, 4, seed=2)]
    monkeypatch.setattr(live.LiveViewer, "_run", lambda self: None)  # nothing drains the queue
    viewer = live.LiveViewer(str(tmp_path), every=2)
    vo = system.VOSystem(cfg, device="cpu")

    def holds_tensor(x):
        if isinstance(x, torch.Tensor):
            return True
        if isinstance(x, dict):
            return any(holds_tensor(v) for k, v in x.items() if k != "cfg")
        return isinstance(x, (list, tuple)) and any(holds_tensor(v) for v in x)

    snaps = []
    for i, (g, d, ts) in enumerate(frames):
        pose = vo.process_frame(g, d, ts)
        viewer.update(vo, vo.prev_frame, pose, i)
        if not viewer._q.empty():
            snaps.append(viewer._q.get_nowait())
    assert [s["idx"] for s in snaps] == [0, 2]
    assert not any(holds_tensor(s) for s in snaps)
    (o0, T0, cloud0), = snaps[0]["kf_ring"]
    assert o0 == 0 and T0.dtype == np.float64 and cloud0[0].shape[1] == 3
    assert snaps[1]["kf_ring"][0][2] is None  # the cloud crossed once
    gray, dt, pts, valid, T_w_k = snaps[1]["overlay"]
    assert gray.dtype == np.uint8 and valid.dtype == np.bool_ and pts.shape[1] == 3
    viewer.update(vo, vo.prev_frame, pose, 4)
    viewer.update(vo, vo.prev_frame, pose, 6)  # queue full: dropped, no error
    assert viewer._q.get_nowait()["idx"] == 4 and viewer._q.empty()
    viewer.close()


def test_live_viewer_logs_errors_and_carries_on(tmp_path, monkeypatch):
    """A render that fails is written to live/viewer_errors.log and the
    viewer goes on to the next snapshot (the JAX viewer's behaviour, which
    is why every other test fails when that file exists)."""
    viewer = live.LiveViewer(str(tmp_path), every=1)
    calls = []

    def render(snap):
        calls.append(snap["idx"])
        if snap["idx"] == 0:
            raise ValueError("boom")

    monkeypatch.setattr(viewer, "_render", render)
    for i in range(2):
        viewer._q.put({"idx": i})
        while not viewer._q.empty():
            pass
    viewer.close()
    assert calls == [0, 1]
    log = (tmp_path / "live" / "viewer_errors.log").read_text()
    assert "frame 0" in log and "boom" in log and "frame 1" not in log
