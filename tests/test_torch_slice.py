"""The port's per-frame tracking step against the JAX package's, on the
same seeded synthetic frames at 160x120 (CPU, plain kernel versions).

build_frame -> make_keyframe -> track_frames for frames 1..3 chained from
the previous pose, for solver "lm" and "gn_fixed" and quad_form "dt4" and
"dt4bf".  Tolerances: bit-equal for images, edges and cloud validity/count;
rtol 1e-6 for cloud points; rtol 1e-6 / atol 1e-5 for DT structures;
rtol 1e-4 / atol 1e-5 for the normalized normal equations (reduction
order); per-frame poses within 1e-5 m and 1e-5 rad.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import frontend as jfront
from revo_tpu import solver as jsolver
from revo_tpu import tracker as jtracker
from revo_tpu.config import SystemConfig as JConfig
from revo_tpu.eval import absolute_trajectory_error as j_ate
from revo_tpu.io import synthetic as jsyn
from revo_tpu_torch import convert, frontend, lie, solver, tracker
from revo_tpu_torch.eval import absolute_trajectory_error as t_ate
from revo_tpu_torch.io import synthetic as tsyn

from test_solver import small_cfg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
POSE_TOL = 1e-5


def _cfg(solver_name="lm", quad_form="dt4bf"):
    cfg = small_cfg()
    opt = dataclasses.replace(
        cfg.tracker.optimizer, solver=solver_name, quad_form=quad_form
    )
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, optimizer=opt)
    )


@pytest.fixture(scope="module")
def seq():
    cam = small_cfg().camera
    scene = tsyn.SyntheticScene()
    traj = scene.trajectory(N, seed=3)
    frames = [tsyn.render_frame(scene, cam, T, seed=3000 + i) for i, T in enumerate(traj)]
    gray = [g.astype(np.uint8) for g, _ in frames]
    depth = [(d * 5000.0).astype(np.uint16) for _, d in frames]
    return gray, depth, traj


def _jax_frames(seq, cfg):
    gray, depth, _ = seq
    return [jfront.build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
            for g, d in zip(gray, depth)]


def _torch_frames(seq, cfg):
    gray, depth, _ = seq
    tcfg = convert.config_from_jax(cfg)
    return [frontend.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg)
            for g, d in zip(gray, depth)]


def _angle(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    s = np.linalg.norm(Ra.T.astype(np.float64) @ Rb - Rb.T @ Ra) / (2 * np.sqrt(2))
    return float(np.arctan2(s, c))


def test_build_frame_matches_jax(seq):
    cfg = _cfg()
    for fj, ft in zip(_jax_frames(seq, cfg), _torch_frames(seq, cfg)):
        for lj, lt in zip(fj.levels, ft.levels):
            np.testing.assert_array_equal(lt.gray.numpy(), np.asarray(lj.gray))
            np.testing.assert_array_equal(lt.depth.numpy(), np.asarray(lj.depth))
            np.testing.assert_array_equal(lt.edges.numpy(), np.asarray(lj.edges))
            np.testing.assert_array_equal(lt.edges_orig.numpy(), np.asarray(lj.edges_orig))
            np.testing.assert_array_equal(lt.cloud.valid.numpy(), np.asarray(lj.cloud.valid))
            assert int(lt.cloud.count) == int(lj.cloud.count)
            np.testing.assert_allclose(
                lt.cloud.points.numpy(), np.asarray(lj.cloud.points), rtol=1e-6, atol=0
            )
    assert int(ft.levels[0].cloud.count) > 1000


@pytest.mark.parametrize("quad_form", ["dt4", "dt4bf"])
def test_make_keyframe_matches_jax(seq, quad_form):
    cfg = _cfg(quad_form=quad_form)
    kj = jfront.make_keyframe(_jax_frames(seq, cfg)[0], jnp.eye(4), cfg)
    kt = frontend.make_keyframe(
        _torch_frames(seq, cfg)[0], torch.eye(4), convert.config_from_jax(cfg)
    )
    for sj, st in zip(kj.structs, kt.structs):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-5)
    for qj, qt in zip(kj.quads, kt.quads):
        assert qt.dtype == (torch.bfloat16 if quad_form == "dt4bf" else torch.float32)
        np.testing.assert_allclose(
            qt.float().numpy(), np.asarray(qj).astype(np.float32), rtol=1e-6, atol=1e-5
        )


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
@pytest.mark.parametrize("quad_form", ["dt4", "dt4bf"])
def test_track_chain_matches_jax(seq, solver_name, quad_form):
    """The whole slice on both sides from the same uint8/uint16 inputs."""
    cfg = _cfg(solver_name, quad_form)
    tcfg = convert.config_from_jax(cfg)
    fj, ft = _jax_frames(seq, cfg), _torch_frames(seq, cfg)
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = frontend.make_keyframe(ft[0], torch.eye(4), tcfg)
    Rj, tj = jnp.eye(3), jnp.zeros(3)
    Rt, tt = torch.eye(3), torch.zeros(3)
    moved = 0.0
    for i in range(1, N):
        rj = jtracker.track_frames(kj, fj[i], Rj, tj, cfg)
        rt = tracker.track_frames(kt, ft[i], Rt, tt, tcfg)
        Rj, tj, Rt, tt = rj.R, rj.t, rt.R, rt.t
        assert float(np.abs(rt.t.numpy() - np.asarray(rj.t)).max()) <= POSE_TOL
        assert _angle(rt.R.numpy(), np.asarray(rj.R)) <= POSE_TOL
        assert int(rt.good) == int(rj.good) and int(rt.bad) == int(rj.bad)
        np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-4)
        assert bool(rt.new_kf) == bool(rj.new_kf)
        moved = max(moved, float(np.linalg.norm(rt.t.numpy())))
    assert moved > 1e-3  # the chain really moved


@pytest.mark.parametrize("solver_name", ["lm", "gn_fixed"])
def test_track_from_jax_keyframe(seq, solver_name):
    """Solver parity isolated from the front end: the port tracks the JAX
    package's own frame and keyframe, carried over by convert."""
    cfg = _cfg(solver_name)
    fj = _jax_frames(seq, cfg)
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = convert.keyframe_from_numpy(_numpy_tree(kj))
    ft = convert.frame_from_numpy(_numpy_tree(fj[2]))
    rj = jtracker.track_frames(kj, fj[2], jnp.eye(3), jnp.zeros(3), cfg)
    rt = tracker.track_frames(kt, ft, torch.eye(3), torch.zeros(3),
                              convert.config_from_jax(cfg))
    assert float(np.abs(rt.t.numpy() - np.asarray(rj.t)).max()) <= POSE_TOL
    assert _angle(rt.R.numpy(), np.asarray(rj.R)) <= POSE_TOL


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_level_system_matches_jax(seq, lvl):
    """One residual evaluation (with JAX's Pallas K3 in interpret mode) at a
    seeded pose and at the identity, where projections land on integer
    pixels."""
    cfg = _cfg()
    opt, cam = cfg.tracker.optimizer, cfg.camera_pyramid()[lvl]
    tcam = convert.config_from_jax(cfg).camera_pyramid()[lvl]
    fj = _jax_frames(seq, cfg)
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = convert.keyframe_from_numpy(_numpy_tree(kj))
    ft = convert.frame_from_numpy(_numpy_tree(fj[1]))
    xi = (np.random.default_rng(lvl).normal(size=6) * 0.004).astype(np.float32)
    R, t = lie.exp_se3(torch.from_numpy(xi))
    # Jitted, as inside track_frames: XLA then fuses u = x / z * fx + cx
    # into one FMA, which the port reproduces (eager JAX rounds twice).
    jsys = jax.jit(lambda q, cloud, R_, t_: jsolver.residual_system(
        q, cloud, cam, R_, t_, opt.edge_distance_lvl[lvl], opt.huber_edge,
        opt.use_edge_filter, True, opt.bilinear_impl,
    ))
    for R_, t_ in ((torch.eye(3), torch.zeros(3)), (R, t)):
        sj = jsys(kj.quads[lvl], fj[1].levels[lvl].cloud,
                  jnp.asarray(R_.numpy()), jnp.asarray(t_.numpy()))
        st = solver.residual_system(
            kt.quads[lvl], ft.levels[lvl].cloud, tcam, R_, t_,
            opt.edge_distance_lvl[lvl], opt.huber_edge, opt.use_edge_filter,
        )
        assert int(st.info.good) == int(sj.info.good)
        assert int(st.info.bad) == int(sj.info.bad)
        for a, b in ((st.err, sj.err), (st.A, sj.A), (st.g, sj.g)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_config_from_jax_round_trip():
    for cfg in (JConfig(), _cfg("gn_fixed", "dt4")):
        port = convert.config_from_jax(cfg)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
        assert convert.config_from_jax(dataclasses.asdict(cfg)) == port
    assert convert.config_from_jax(JConfig()) == type(port)()


def test_frame_and_keyframe_round_trip(seq):
    cfg = _cfg()
    fj = _jax_frames(seq, cfg)[1]
    kj = jfront.make_keyframe(fj, jnp.eye(4), cfg)
    kt = convert.keyframe_from_numpy(_numpy_tree(kj))
    for lj, lt in zip(kj.frame.levels, kt.frame.levels):
        for name in ("gray", "depth", "edges", "edges_orig"):
            np.testing.assert_array_equal(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)))
        np.testing.assert_array_equal(lt.cloud.points.numpy(), np.asarray(lj.cloud.points))
        assert lt.cloud.valid.dtype == torch.bool
    for qj, qt in zip(kj.quads, kt.quads):
        assert qt.dtype == torch.bfloat16
        np.testing.assert_array_equal(qt.float().numpy(), np.asarray(qj).astype(np.float32))
    np.testing.assert_array_equal(kt.T_w_k.numpy(), np.eye(4, dtype=np.float32))


def test_renderer_and_ate_match_jax(seq):
    cam = small_cfg().camera
    _, _, traj = seq
    want_traj = jsyn.SyntheticScene().trajectory(N, seed=3)
    np.testing.assert_allclose(traj, want_traj, rtol=0, atol=1e-6)
    g_t, d_t = tsyn.render_frame(tsyn.SyntheticScene(), cam, traj[1], seed=7)
    g_j, d_j = jsyn.render_frame(jsyn.SyntheticScene(), cam, traj[1], seed=7)
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_array_equal(d_t, d_j)
    seq_t = tsyn.render_sequence(tsyn.SyntheticScene(), cam, 2, seed=1)
    seq_j = jsyn.render_sequence(jsyn.SyntheticScene(), cam, 2, seed=1)
    # Each side draws its trajectory through its own lie (poses within
    # 1e-6), so depth may differ in the last bit where a ray grazes.
    for (g_t, d_t, T_t, ts_t), (g_j, d_j, T_j, ts_j) in zip(seq_t, seq_j):
        np.testing.assert_allclose(T_t, T_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-3)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=0)
        assert ts_t == ts_j
    est = traj.astype(np.float64).copy()
    est[:, :3, 3] += np.random.default_rng(0).normal(scale=1e-3, size=(N, 3))
    assert t_ate(est, traj).rmse == pytest.approx(j_ate(est, traj).rmse, rel=1e-12)


def test_import_loads_no_jax():
    """Every port module imports with jax and revo_tpu blocked, and loads
    neither."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'revo_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import revo_tpu_torch, revo_tpu_torch.frontend, revo_tpu_torch.tracker\n"
        "import revo_tpu_torch.convert, revo_tpu_torch.kernels\n"
        "import revo_tpu_torch.io.synthetic, revo_tpu_torch.eval\n"
        "import revo_tpu_torch.system, revo_tpu_torch.parallel.batch\n"
        "import revo_tpu_torch.autotune, revo_tpu_torch.io.tum, revo_tpu_torch.run\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'revo_tpu' or m.startswith('revo_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
