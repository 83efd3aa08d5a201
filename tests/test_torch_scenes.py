"""The port's scene families and loop trajectory against the JAX package's
(revo_tpu/io/synthetic.py), and VOSystem over them in both packages (CPU,
plain kernel versions; JAX jitted on the CPU as its own tests run it).

Tolerances: scene geometry equal field by field; ``loop_trajectory`` and the
rendered gray and depth bit-equal; VOSystem over 12 frames of the box and
column scenes at 160x120: per-frame flags identical, poses within 5e-5 m and
5e-5 rad; the sparse scene's edges before and after the BMVC17 fill-in
bit-equal at 320x240, where the fill-in fires.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import system as jsystem
from revo_tpu.config import SystemConfig as JConfig
from revo_tpu.io import synthetic as jsyn
from revo_tpu_torch import convert, frontend, system
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.ops.edge_hist import patch_histogram

from test_solver import small_cfg
from test_torch_vo import assert_poses_close, run_host

torch.set_num_threads(1)

SCENE_TOL = 5e-5  # metres and radians, port against JAX
FAMILIES = ("box_scene", "sparse_scene", "column_scene")


def _assert_scene_equal(st, sj):
    assert len(st.planes) == len(sj.planes) and len(st.cylinders) == len(sj.cylinders)
    for pt, pj in zip(st.planes, sj.planes):
        for name in ("n", "a1", "a2"):
            np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
        assert (pt.d, pt.phase, pt.bounds, pt.texture, pt.flat_value) == (
            pj.d, pj.phase, pj.bounds, pj.texture, pj.flat_value)
    for ct, cj in zip(st.cylinders, sj.cylinders):
        np.testing.assert_array_equal(ct.center, cj.center)
        assert (ct.radius, ct.ylo, ct.yhi, ct.phase) == (cj.radius, cj.ylo, cj.yhi, cj.phase)
    for f in dataclasses.fields(st):
        if f.name not in ("planes", "cylinders"):
            assert getattr(st, f.name) == getattr(sj, f.name)


@pytest.mark.parametrize("family", FAMILIES)
def test_scene_family_matches_jax(family):
    kw = dict(depth_noise=0.02, depth_hole_frac=0.1, image_noise=1.5)
    st, sj = getattr(tsyn, family)(**kw), getattr(jsyn, family)(**kw)
    _assert_scene_equal(st, sj)
    assert len(st.planes) in (3, 15) and st.depth_noise == 0.02


@pytest.mark.parametrize("texture, flat_base", [("full", 120.0), ("flat", 200.0)])
def test_box_faces_match_jax(texture, flat_base):
    args = ((0.1, -0.2, 2.0), (0.3, 0.2, 0.1))
    ft = tsyn.box_faces(*args, phase0=1.5, texture=texture, flat_base=flat_base)
    fj = jsyn.box_faces(*args, phase0=1.5, texture=texture, flat_base=flat_base)
    assert len(ft) == 6
    _assert_scene_equal(tsyn.SyntheticScene(planes=ft), jsyn.SyntheticScene(planes=fj))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("circuits", [1, 2])
def test_loop_trajectory_bit_equal(seed, circuits):
    """Each rotation goes through the C library's sinf / cosf, as XLA's CPU
    scalar sine and cosine do: a last-bit difference would move rendered
    pixels.  Lengths 40, 110 and 200 cover angles where torch.sin / torch.cos
    round differently."""
    for n, radius in ((40, 0.25), (110, 0.75), (200, 0.5)):
        got = tsyn.loop_trajectory(n, radius=radius, wobble=0.004, seed=seed, circuits=circuits)
        want = jsyn.loop_trajectory(n, radius=radius, wobble=0.004, seed=seed, circuits=circuits)
        assert got.dtype == want.dtype == np.float32 and got.shape == (n, 4, 4)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[-1], got[0], atol=1e-6)  # the loop closes
    still = tsyn.loop_trajectory(12, wobble=0.0, seed=seed, circuits=circuits)
    np.testing.assert_array_equal(
        still, jsyn.loop_trajectory(12, wobble=0.0, seed=seed, circuits=circuits))


@pytest.mark.parametrize("family", FAMILIES)
def test_rendered_frame_bit_equal(family):
    """One frame per scene family at a pose of the loop, with depth noise
    and holes drawn from the frame's seed: gray and depth equal bit for bit."""
    cam = small_cfg().camera
    kw = dict(depth_noise=0.01, depth_hole_frac=0.05)
    T = jsyn.loop_trajectory(30, radius=0.75, seed=5)[7]
    g_t, d_t = tsyn.render_frame(getattr(tsyn, family)(**kw), convert.config_from_jax(
        small_cfg()).camera, T, seed=11)
    g_j, d_j = jsyn.render_frame(getattr(jsyn, family)(**kw), cam, T, seed=11)
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_array_equal(d_t, d_j)
    assert g_t.std() > 5 and (d_t > 0).mean() > 0.5


def test_render_trajectory_matches_jax():
    cam = small_cfg().camera
    traj = tsyn.loop_trajectory(3, seed=1)
    for (g_t, d_t, T_t, ts_t), (g_j, d_j, T_j, ts_j) in zip(
            tsyn.render_trajectory(tsyn.column_scene(), cam, traj, seed=2),
            jsyn.render_trajectory(jsyn.column_scene(), cam, traj, seed=2)):
        np.testing.assert_array_equal(g_t, g_j)
        np.testing.assert_array_equal(d_t, d_j)
        np.testing.assert_array_equal(T_t, T_j)
        assert ts_t == ts_j


@pytest.mark.parametrize("family, seed", [("box_scene", 3), ("column_scene", 3)])
def test_vosystem_on_scene_matches_jax(family, seed):
    """12 handheld frames through both VOSystems: flags equal, poses within
    5e-5 (seeds away from knife-edge frames, ROADMAP "Knife-edge basins")."""
    cfg = small_cfg()
    tcfg = convert.config_from_jax(cfg)
    scene = getattr(tsyn, family)()
    frames = [(g, d, ts) for g, d, _, ts in tsyn.render_sequence(scene, tcfg.camera, 12, seed=seed)]
    pj, fj = run_host(jsystem.VOSystem(cfg), frames)
    vt = system.VOSystem(tcfg, device="cpu")
    pt, ft = run_host(vt, frames)
    np.testing.assert_array_equal(ft, fj)
    assert vt.n_tracking_lost == 0
    assert_poses_close(pt, pj, tol=SCENE_TOL)
    assert np.linalg.norm(pt[-1, :3, 3]) > 0.01  # the camera moved


def _half_cfg():
    """320x240: the largest size a CPU test should build, and the smallest
    at which the sparse scene's coarse levels fall under n_percentage."""
    base = JConfig()
    c = base.camera
    cam = dataclasses.replace(c, width=320, height=240, fx=c.fx / 2, fy=c.fy / 2,
                              cx=c.cx / 2, cy=c.cy / 2)
    return dataclasses.replace(base, camera=cam)


def test_sparse_scene_fill_in_matches_jax():
    """tests/test_scenes.py:184-207 in both packages on one frame: the
    fill-in fires at levels 1 and 2, and edges before and after it are equal
    bit for bit, so the filled-in counts are."""
    cfg = _half_cfg()
    tcfg = convert.config_from_jax(cfg)
    g, d = tsyn.render_frame(tsyn.sparse_scene(), tcfg.camera, np.eye(4), seed=1)
    fj = jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
    ft = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg)
    for lvl in (1, 2):
        lt, lj = ft.levels[lvl], fj.levels[lvl]
        np.testing.assert_array_equal(lt.edges_orig.numpy(), np.asarray(lj.edges_orig))
        np.testing.assert_array_equal(lt.edges.numpy(), np.asarray(lj.edges))
        occ = float(patch_histogram(lt.edges_orig, tcfg.pyramid.dist_patch_sizes[lvl])[1])
        assert occ < tcfg.pyramid.n_percentage, f"level {lvl} occupancy {occ} not sparse"
        filled = int(lt.edges.sum()) - int(lt.edges_orig.sum())
        assert filled > 0 and filled == int(lj.edges.sum()) - int(lj.edges_orig.sum())
    # The textured box scene is dense: the fill-in leaves it alone.
    g, d = tsyn.render_frame(tsyn.box_scene(), tcfg.camera, np.eye(4), seed=1)
    fb = frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg)
    assert all(torch.equal(lv.edges, lv.edges_orig) for lv in fb.levels)
