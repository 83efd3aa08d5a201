"""The port's bilinear image sampling, lens undistortion and PLY export
against the JAX package's, at 160x120 on the CPU.

Tolerances: ``bilinear_sample`` and ``remap_bilinear`` within 1e-5 of jitted
JAX (gray levels up to 255: under one float32 ulp there); the undistortion
maps bit for bit (the same float64 numpy, copied); ``build_frame`` with maps:
rectified gray and edges equal, depth within 1e-6; ``VOSystem`` with
``undistort=True`` on a distorted sequence: per-frame flags identical,
poses within 1e-4; ``generate_colored_pcl`` arrays equal; PLY files equal
byte for byte for the same arrays.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfrontend
from revo_tpu import system as jsystem
from revo_tpu.config import CameraConfig as JCamera
from revo_tpu.config import SystemConfig as JSystemConfig
from revo_tpu.ops import interp as jinterp
from revo_tpu.ops import undistort as jund
from revo_tpu.viz import ply as jply
from revo_tpu_torch import convert, frontend, system
from revo_tpu_torch.eval import absolute_trajectory_error
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.ops import interp, undistort
from revo_tpu_torch.viz import ply

from test_ops import synthetic_gray
from test_torch_vo import assert_poses_close, run_host

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import distort_capture  # noqa: E402

torch.set_num_threads(1)

# tests/test_undistort_recorder.py: TUM fr1 coefficients on a 160x120 camera.
JCAM_DIST = JCamera(fx=200.0, fy=201.0, cx=81.0, cy=59.5, width=160, height=120,
                    distortion=(0.26, -0.95, -0.005, 0.0026, 1.16))


def _distorted_cfg():
    base = JSystemConfig()
    return JSystemConfig(
        camera=JCAM_DIST,
        pyramid=dataclasses.replace(
            base.pyramid, pyr_min_lvl=2, pyr_max_lvl=0, edge_capacity=(4096, 2048, 1024),
            dist_patch_sizes=(20, 10, 5), undistort=True),
        tracker=dataclasses.replace(base.tracker, store_kf_images=True),
    )


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(-3, 30, (37, 53, 3)).astype(np.float32)
    u = rng.uniform(-4, 57, 4000).astype(np.float32)
    v = rng.uniform(-4, 41, 4000).astype(np.float32)
    u[:50] = np.round(u[:50])  # integer coordinates: zero fractions
    want = np.asarray(jax.jit(jinterp.bilinear_sample)(jnp.asarray(img), jnp.asarray(u),
                                                       jnp.asarray(v)))
    got = interp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v))
    assert got.shape == (4000, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # Coordinates no int can hold stay in memory (callers mask such lanes).
    wild = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30])
    assert interp.bilinear_sample(torch.from_numpy(img), wild, wild).shape == (4, 3)
    # The stacked form picks its image by index.
    stack = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    idx = torch.from_numpy(rng.integers(0, 2, 4000))
    both = interp.bilinear_sample_stacked(stack, idx, torch.from_numpy(u), torch.from_numpy(v))
    flipped = interp.bilinear_sample(stack[1], torch.from_numpy(u), torch.from_numpy(v))
    assert torch.equal(both, torch.where(idx[:, None] == 0, got, flipped))


def test_undistort_maps_equal_jax():
    tcam = convert.config_from_jax(_distorted_cfg()).camera
    mu, mv = undistort.build_undistort_maps(tcam)
    mu_j, mv_j = jund.build_undistort_maps(JCAM_DIST)
    assert mu.dtype == np.float32 and mu.shape == (120, 160)
    np.testing.assert_array_equal(mu, mu_j)
    np.testing.assert_array_equal(mv, mv_j)
    plain = dataclasses.replace(tcam, distortion=(0.0,) * 5)
    mu0, mv0 = undistort.build_undistort_maps(plain)
    uu, vv = np.meshgrid(np.arange(160.0), np.arange(120.0))
    np.testing.assert_allclose(mu0, uu, atol=1e-4)
    np.testing.assert_allclose(mv0, vv, atol=1e-4)


def test_remap_bilinear_matches_jax_and_opencv():
    import cv2

    img = synthetic_gray(120, 160, seed=1).astype(np.float32)
    mu, mv = jund.build_undistort_maps(JCAM_DIST)
    want = np.asarray(jund.remap_bilinear(jnp.asarray(img), jnp.asarray(mu), jnp.asarray(mv)))
    got = undistort.remap_bilinear(
        torch.from_numpy(img), torch.from_numpy(mu), torch.from_numpy(mv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # uint8 input converts on the way, as JAX's astype does.
    got_u8 = undistort.remap_bilinear(
        torch.from_numpy(img.astype(np.uint8)), torch.from_numpy(mu), torch.from_numpy(mv))
    assert torch.equal(got_u8, torch.from_numpy(got))
    inner = (slice(3, -3), slice(3, -3))  # the border is clamped, not constant
    np.testing.assert_allclose(got[inner], cv2.remap(img, mu, mv, cv2.INTER_LINEAR)[inner],
                               atol=0.51)


def test_distort_capture_matches_opencv_inversion():
    """The numpy lens emulation the chip run uses (fixed-point inversion of
    the model) against tests/test_undistort_recorder.py's cv2 one."""
    from test_undistort_recorder import _distort_capture

    cam = convert.config_from_jax(_distorted_cfg()).camera
    gray, depth = tsyn.render_frame(tsyn.SyntheticScene(), cam, np.eye(4, dtype=np.float32))
    g_np, d_np = distort_capture(gray, depth, cam)
    g_cv, d_cv = _distort_capture(gray, depth, JCAM_DIST)
    inner = (slice(3, -3), slice(3, -3))
    # cv2.remap interpolates with 1/32-pixel fixed-point weights.
    assert float(np.abs(g_np - g_cv)[inner].mean()) < 0.25
    assert float((d_np != d_cv)[inner].mean()) < 0.01


@pytest.fixture(scope="module")
def distorted():
    """20 frames of render_sequence seed 3 through the lens emulation
    (tests/test_undistort_recorder.py's sequence), and their ground truth."""
    cfg = _distorted_cfg()
    tcfg = convert.config_from_jax(cfg)
    frames, gt = [], []
    for gray, depth, T, ts in tsyn.render_sequence(tsyn.SyntheticScene(), tcfg.camera, 20, seed=3):
        frames.append((*distort_capture(gray, depth, tcfg.camera), ts))
        gt.append(T)
    return cfg, tcfg, frames, np.stack(gt)


def test_build_frame_undistorts_like_jax(distorted):
    cfg, tcfg, frames, _ = distorted
    g, d, _ = frames[0]
    maps = jund.build_undistort_maps(JCAM_DIST)
    fj = jfrontend.build_frame(jnp.asarray(g), jnp.asarray(d), cfg,
                               tuple(jnp.asarray(m) for m in maps))
    ft = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg,
                              tuple(torch.from_numpy(m) for m in maps))
    plain = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg)
    assert not torch.equal(ft.levels[0].gray, plain.levels[0].gray)  # maps given, maps used
    for a, b in zip(ft.levels, fj.levels):
        np.testing.assert_array_equal(a.gray.numpy(), np.asarray(b.gray))
        np.testing.assert_array_equal(a.edges.numpy(), np.asarray(b.edges))
        np.testing.assert_allclose(a.depth.numpy(), np.asarray(b.depth), rtol=0, atol=1e-6)
        assert int(a.cloud.count) == int(b.cloud.count)
    # Gray is rounded back to uint8 levels after the remap, depth is not.
    g0 = ft.levels[0].gray
    assert torch.equal(g0, torch.round(g0))
    assert not torch.equal(ft.levels[0].depth, torch.round(ft.levels[0].depth * 1e3) / 1e3)


def test_vo_on_distorted_sequence_matches_jax(distorted):
    cfg, tcfg, frames, gt = distorted
    vt = system.VOSystem(tcfg, device="cpu")
    assert vt.undistort_maps is not None and vt.undistort_maps[0].device.type == "cpu"
    p_t, f_t = run_host(vt, frames)
    p_j, f_j = run_host(jsystem.VOSystem(cfg), frames)
    np.testing.assert_array_equal(f_t, f_j)
    assert_poses_close(p_t, p_j, 1e-4)
    assert absolute_trajectory_error(p_t, gt).rmse < 0.01
    # The keyframe the system holds is the rectified image: close to the
    # ideal render, and not the distorted capture.
    ideal0, _ = tsyn.render_frame(tsyn.SyntheticScene(), tcfg.camera, gt[0])
    kf_gray = vt.kf_history[0][1].frame.levels[0].gray.numpy()
    inner = (slice(8, -8), slice(8, -8))
    diff = float(np.abs(kf_gray - ideal0.astype(np.float32))[inner].mean())
    diff_raw = float(np.abs(kf_gray - frames[0][0])[inner].mean())
    assert diff < 3.0 and diff < 0.5 * diff_raw, (diff, diff_raw)


def test_colored_pcl_and_ply_files_equal_jax(distorted, tmp_path):
    cfg, tcfg, frames, _ = distorted
    g, d, _ = frames[0]
    fj = jfrontend.build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
    ft = convert.frame_from_numpy(jax.tree.map(np.asarray, fj), device="cpu")
    rgb = np.random.default_rng(0).uniform(0, 1, (120, 160, 3)).astype(np.float32)
    for kw in (dict(), dict(dense=True), dict(lvl=1), dict(rgb01=rgb)):
        pts_t, clr_t = frontend.generate_colored_pcl(ft, tcfg, **kw)
        pts_j, clr_j = jfrontend.generate_colored_pcl(fj, cfg, **kw)
        assert len(pts_t) > 100 and pts_t.dtype == np.float32
        np.testing.assert_array_equal(pts_t, pts_j)
        np.testing.assert_array_equal(clr_t, clr_j)
    assert clr_t.min() >= 0.0 and clr_t.max() <= 1.0

    pts, clr = frontend.generate_colored_pcl(ft, tcfg)
    xs = np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32) * 0.2
    from revo_tpu_torch import lie

    poses = lie.matrix_from_rt(*lie.exp_se3(torch.from_numpy(xs))).numpy()
    calls = [
        ("pcl.ply", "export_colored_pcl_ply", (pts, clr)),
        ("kf.ply", "export_keyframe_frusta_ply", (list(poses),)),
        ("kf0.ply", "export_keyframe_frusta_ply", ([],)),
        ("traj.ply", "export_trajectory_ply", (poses,)),
    ]
    for name, fn, args in calls:
        a, b = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        getattr(ply, fn)(str(a), *args)
        getattr(jply, fn)(str(b), *args)
        assert a.read_bytes() == b.read_bytes(), name
    head = (tmp_path / "t_pcl.ply").read_text().splitlines()
    assert head[0] == "ply" and head[2] == f"element vertex {len(pts)}"
    assert "element vertex 15" in (tmp_path / "t_kf.ply").read_text()
    assert "element edge 26" in (tmp_path / "t_kf.ply").read_text()
