"""The port's per-frame tracking step against the JAX package's, on the
same seeded synthetic frames at 160x120 (CPU, plain kernel versions).

build_frame -> make_keyframe -> track_frames for frames 1..3 chained from
the previous pose, for solver "lm" and "gn_fixed" and quad_form "dt4" and
"dt4bf".  Tolerances: bit-equal for images, edges and cloud validity/count;
rtol 1e-6 for cloud points; rtol 1e-6 / atol 1e-5 for DT structures;
one evaluation's per-point terms bit-equal, and its normalized normal
equations within the float32 summation bound of the float64 sum of those
terms (reduction order); per-frame poses within 1e-5 m and 1e-5 rad.
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
from revo_tpu.ops.pallas import lgsx as jlgsx
from revo_tpu_torch import convert, frontend, lie, solver, tracker
from revo_tpu_torch.eval import absolute_trajectory_error as t_ate
from revo_tpu_torch.io import synthetic as tsyn
from revo_tpu_torch.ops import lgsx as K3

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
    kt = convert.keyframe_from_numpy(_numpy_tree(kj), device="cpu")
    ft = convert.frame_from_numpy(_numpy_tree(fj[2]), device="cpu")
    rj = jtracker.track_frames(kj, fj[2], jnp.eye(3), jnp.zeros(3), cfg)
    rt = tracker.track_frames(kt, ft, torch.eye(3), torch.zeros(3),
                              convert.config_from_jax(cfg))
    assert float(np.abs(rt.t.numpy() - np.asarray(rj.t)).max()) <= POSE_TOL
    assert _angle(rt.R.numpy(), np.asarray(rj.R)) <= POSE_TOL


U32 = 2.0 ** -24  # float32 unit roundoff
SUMMAND_OPS = 16  # float32 operations from one point's terms to its summand


def jax_residual_fn(cam, edge_distance, huber, use_edge_filter, bilinear_impl):
    """The JAX package's residual pass, jitted as inside track_frames, with
    its Pallas K3 in interpret mode: (table, cloud, R, t) -> (the
    normalized LevelSystem, the per-point terms (warped points, scaled
    gradients, r, w) that its reduction receives)."""
    def fn(table, cloud, R, t):
        stash = []
        reduce_ = jlgsx.lgsx_reduce

        def capture(wxp, grads, r, w):
            stash.append((wxp, grads, r, w))
            return reduce_(wxp, grads, r, w)

        jlgsx.lgsx_reduce = capture  # _residual_sums imports it when called
        try:
            sums = jsolver._residual_sums(table, cloud, cam, R, t, edge_distance, huber,
                                          use_edge_filter, True, bilinear_impl)
        finally:
            jlgsx.lgsx_reduce = reduce_
        return jsolver._normalize_sums(*sums), stash[0]

    return jax.jit(fn)


def float64_system(wxp, grads, r, w, n_good):
    """(A, g, err) of the per-point terms summed in float64, and beside each
    the float32 bound gamma_m * sum |summand| / n_good + U32 |value| (m = P +
    SUMMAND_OPS; each Jacobian entry bounded by its formula in absolute
    values), which any float32 evaluation of the same terms meets in any
    order of summation."""
    wxp, grads, r, w = (np.asarray(x, np.float64) for x in (wxp, grads, r, w))
    px, py, pz = wxp.T
    gx, gy = grads.T
    iz = 1.0 / np.where(pz == 0, 1e-12, pz)
    iz2 = iz * iz
    J = np.stack([iz * gx, iz * gy, -px * iz2 * gx - py * iz2 * gy,
                  -px * py * iz2 * gx - (1 + py * py * iz2) * gy,
                  (1 + px * px * iz2) * gx + px * py * iz2 * gy, -py * iz * gx + px * iz * gy], -1)
    a, b, c, d = np.abs(px), np.abs(py), np.abs(gx), np.abs(gy)
    Jabs = np.stack([iz * c, iz * d, a * iz2 * c + b * iz2 * d,
                     a * b * iz2 * c + (1 + b * b * iz2) * d,
                     (1 + a * a * iz2) * c + a * b * iz2 * d, b * iz * c + a * iz * d], -1)
    Jabs = np.abs(Jabs)
    live = w != 0  # dead lanes add exact zeros
    J, Jabs, r, w = J[live], Jabs[live], r[live], w[live]
    m = len(wxp) + SUMMAND_OPS
    gamma = m * U32 / (1 - m * U32)
    n = max(int(n_good), 1)
    out = []
    for value, absolute in ((np.einsum("p,pi,pj->ij", w, J, J), np.einsum("p,pi,pj->ij", w, Jabs, Jabs)),
                            (np.einsum("p,pi->i", w * r, J), np.einsum("p,pi->i", np.abs(w * r), Jabs)),
                            (np.sum(w * r * r), np.sum(np.abs(w * r * r)))):
        value = value / n
        out.append((value, gamma * absolute / n + U32 * np.abs(value)))
    return out


def assert_terms_and_sums(sj, terms_j, st, terms_t):
    """The port's per-point terms bit-equal to the JAX package's, equal
    counts, and both packages' normalized sums within the float32 bound of
    the float64 sum of those terms."""
    wxp, grads, r, w, _, n_good, n_bad = terms_t
    for a, b in zip((wxp, grads, r, w), terms_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(n_good) == int(st.info.good) == int(sj.info.good) > 0
    assert int(n_bad) == int(st.info.bad) == int(sj.info.bad)
    for (want, bound), port, jx in zip(float64_system(wxp, grads, r, w, n_good),
                                       (st.A, st.g, st.err), (sj.A, sj.g, sj.err)):
        for got in (port.numpy(), np.asarray(jx)):
            assert np.all(np.abs(got - want) <= bound), (np.abs(got - want) / bound).max()


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_level_system_matches_jax(seq, lvl):
    """One residual evaluation at a seeded pose and at the identity, where
    projections land on integer pixels: the per-point terms (warped
    points, gradients, r, w) bit-equal and the counts equal to the jitted
    JAX pass's; A, g and err of both packages within the float32
    summation bound of the float64 sum of those terms (each package sums
    in its own order, so neither matches the other entry by entry)."""
    cfg = _cfg()
    opt, cam = cfg.tracker.optimizer, cfg.camera_pyramid()[lvl]
    tcam = convert.config_from_jax(cfg).camera_pyramid()[lvl]
    fj = _jax_frames(seq, cfg)
    kj = jfront.make_keyframe(fj[0], jnp.eye(4), cfg)
    kt = convert.keyframe_from_numpy(_numpy_tree(kj), device="cpu")
    ft = convert.frame_from_numpy(_numpy_tree(fj[1]), device="cpu")
    xi = (np.random.default_rng(lvl).normal(size=6) * 0.004).astype(np.float32)
    R, t = lie.exp_se3(torch.from_numpy(xi))
    jsys = jax_residual_fn(cam, opt.edge_distance_lvl[lvl], opt.huber_edge,
                           opt.use_edge_filter, opt.bilinear_impl)
    for R_, t_ in ((torch.eye(3), torch.zeros(3)), (R, t)):
        sj, terms_j = jsys(kj.quads[lvl], fj[1].levels[lvl].cloud,
                           jnp.asarray(R_.numpy()), jnp.asarray(t_.numpy()))
        args = (kt.quads[lvl], ft.levels[lvl].cloud, tcam, R_, t_,
                opt.edge_distance_lvl[lvl], opt.huber_edge, opt.use_edge_filter)
        assert_terms_and_sums(sj, terms_j, solver.residual_system(*args),
                              K3.residual_terms(*args))


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
    kt = convert.keyframe_from_numpy(_numpy_tree(kj), device="cpu")
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
    """Every port module (the package is walked, so a new module cannot be
    forgotten) imports with jax and revo_tpu blocked, and loads neither, nor
    matplotlib or OpenCV, which the views import inside their functions; no
    source line of the port or of chip_smoke.py (whose imports run inside
    main, on the card) imports jax or revo_tpu."""
    import glob
    import re

    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|revo_tpu)(?:[.\s]|$)", re.M)
    sources = glob.glob(os.path.join(REPO, "revo_tpu_torch", "**", "*.py"), recursive=True)
    assert len(sources) > 40
    for path in sources + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            assert not pat.search(f.read()), path
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
        "import revo_tpu_torch.parallel.posegraph, revo_tpu_torch.loopclosure\n"
        "import revo_tpu_torch.checkpoint, revo_tpu_torch.ops.canny, revo_tpu_torch.ops.lgsx\n"
        "import revo_tpu_torch.parallel.windowed, revo_tpu_torch.parallel.segments\n"
        "import revo_tpu_torch.parallel.mesh, revo_tpu_torch.parallel.pipeline\n"
        "import revo_tpu_torch.ops.undistort, revo_tpu_torch.viz.ply\n"
        "import revo_tpu_torch.lie, revo_tpu_torch.utils, revo_tpu_torch.utils.trace\n"
        "import revo_tpu_torch.utils.logging\n"
        "import revo_tpu_torch.io, revo_tpu_torch.io._native, revo_tpu_torch.io.native_loader\n"
        "import revo_tpu_torch.io.sensors, revo_tpu_torch.io.recorder\n"
        "import revo_tpu_torch.io.native_oracle, revo_tpu_torch.io.associate\n"
        "import revo_tpu_torch.viz, revo_tpu_torch.viz.plot, revo_tpu_torch.viz.debug\n"
        "import revo_tpu_torch.viz.map3d, revo_tpu_torch.viz.live\n"
        "import revo_tpu_torch.bench, revo_tpu_torch.entry\n"
        "import pkgutil\n"
        "walked = [m.name for m in pkgutil.walk_packages(revo_tpu_torch.__path__, 'revo_tpu_torch.')]\n"
        "missing = [m for m in walked if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "assert not [m for m in ('matplotlib', 'cv2') if m in sys.modules]\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'revo_tpu' or m.startswith('revo_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
