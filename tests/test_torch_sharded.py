"""The port's sharded forms against the JAX package's, on the CPU at 160x120:
the point-sharded normal equations (``solver.residual_system_point_sharded``),
candidate verification sharded over "cand", and the pose graph and windowed
BA with their reductions sharded; the sequence-sharded scan and segments are
in tests/test_torch_sharded_seq.py.  The JAX side runs on conftest's 8
virtual CPU devices, the port's on ``[torch.device("cpu")] * n`` slots.

Tolerances:
- point-sharded system: good and bad counts equal, A and g within rtol 1e-4 /
  atol 1e-6 of JAX's sharded system and of the port's unsharded one
  (tests/test_lgsx_sharded.py:62-80), and bit-equal to the port's own
  per-shard ``_residual_sums`` added in slot order.  JAX's function samples
  the (H, W, 3) structure with its take4 sampler, and so does the port's
  with the same structure as rows (the "take4" case, like against like);
  for the port's dt quad tables JAX's ``_residual_sums`` is bound to its
  "quad" sampler.  JAX runs jitted, as inside its tracker;
- candidates: verdicts and T_ab bit-equal to the port's mesh-less run (the
  same program per pair); against JAX's mesh form verdicts equal and T_ab
  within 1e-4;
- pose graph within 1e-4 and windowed BA within 2e-4 of JAX's sharded result
  and of the port's unsharded one (tests/test_posegraph.py:104-125,
  tests/test_windowed.py:372-384).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import solver as jsolver
from revo_tpu.config import OptimizerConfig as JOpt
from revo_tpu.loopclosure import verify_candidates_batched as jverify
from revo_tpu.ops.backproject import EdgeCloud as JCloud
from revo_tpu.parallel import posegraph as jpg, windowed as jw
from revo_tpu_torch import convert, lie, loopclosure as lc, solver
from revo_tpu_torch.config import OptimizerConfig
from revo_tpu_torch.ops.backproject import EdgeCloud
from revo_tpu_torch.ops.edt import keyframe_structure, quad_structure
from revo_tpu_torch.parallel import posegraph as pg, windowed as tw
from revo_tpu_torch.parallel.mesh import make_mesh, replicate, shard

from test_loopclosure import _loop_keyframes
from test_posegraph import _mean_residual as _jmean_residual, _perturb, _random_trajectory
from test_solver import CAM as JCAM, _cloud_from_points, _rasterize_edges, _wireframe_points
from test_torch_loopclosure import _same_verdicts
from test_windowed import _build_window

torch.set_num_threads(1)

CAM = convert._SECTIONS["camera"](**convert._fields(JCAM))


def cpu_mesh(n, axis):
    return make_mesh((axis,), devices=[torch.device("cpu")] * n)


def jax_mesh(n, axis):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), (axis,))


# -- point-sharded normal equations -------------------------------------------


@pytest.fixture(scope="module")
def wireframe():
    """tests/test_lgsx_sharded.py:14-19 from numpy: the wireframe's edges,
    their keyframe structure and a 1024-lane cloud."""
    pts = _wireframe_points()
    edges = _rasterize_edges(pts, JCAM)
    jcloud = _cloud_from_points(pts, capacity=1024)
    cloud = EdgeCloud(torch.from_numpy(np.asarray(jcloud.points)),
                      torch.from_numpy(np.asarray(jcloud.valid)),
                      torch.tensor(int(jcloud.count), dtype=torch.int32))
    return keyframe_structure(torch.from_numpy(edges)), cloud


def _jax_point_sharded(table, cloud, R, t, mesh, form, struct=None):
    """JAX's ``residual_system_point_sharded``, jitted as inside its tracker.
    "take4": JAX's own form, the (H, W, 3) ``struct`` sampled by its take4
    sampler (the port gets the same structure as (H*W, 3) rows); "dt4" /
    "dt4bf": the port's dt quad ``table``, for which JAX's
    ``_residual_sums`` is bound to its "quad" sampler."""
    if form == "take4":
        jq = jnp.asarray(struct.numpy())
        bind = {}
    else:
        jq = jnp.asarray(table.float().numpy())
        if form == "dt4bf":
            jq = jq.astype(jnp.bfloat16)
        bind = {"bilinear_impl": "quad"}
    orig = jsolver._residual_sums
    jsolver._residual_sums = functools.partial(orig, **bind)
    try:
        return jax.jit(lambda q, p, v, R_, t_: jsolver.residual_system_point_sharded(
            q, JCloud(p, v, v.sum().astype(jnp.int32)), JCAM, R_, t_, 30.0, 0.3, True,
            mesh=mesh))(jq, cloud.points.numpy(), cloud.valid.numpy(), R.numpy(), t.numpy())
    finally:
        jsolver._residual_sums = orig


def _table(struct, form):
    """The table the port's solver samples for ``form``."""
    return struct.flatten(0, 1) if form == "take4" else quad_structure(struct, form)


def _assert_system_close(a, b):
    assert int(a.info.good) == int(b.info.good) and int(a.info.bad) == int(b.info.bad)
    for x, y in ((a.A, b.A), (a.g, b.g)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("quad_form", ["dt4", "dt4bf", "take4"])
@pytest.mark.parametrize("pose", ["identity", "moved"])
def test_point_sharded_system(wireframe, quad_form, pose):
    struct, cloud = wireframe
    quad = _table(struct, quad_form)
    xi = torch.tensor([0.01, -0.008, 0.012, 0.004, -0.006, 0.005]) * (pose == "moved")
    R, t = lie.exp_se3(xi)
    mesh = cpu_mesh(8, "pt")
    got = solver.residual_system_point_sharded(quad, cloud, CAM, R, t, 30.0, 0.3, True, mesh)
    assert int(got.info.good) > 400 and got.info.good.dtype == torch.int32
    _assert_system_close(got, _jax_point_sharded(quad, cloud, R, t, jax_mesh(8, "pt"), quad_form,
                                                 struct))
    _assert_system_close(got, solver.residual_system(quad, cloud, CAM, R, t, 30.0, 0.3, True))
    # Bit-equal to the port's own shards summed in slot order.
    shards = [solver._residual_sums(q, EdgeCloud(p, v, v.sum(dtype=torch.int32)), CAM, R, t,
                                    30.0, 0.3, True)
              for q, p, v in zip(replicate(quad, mesh, "pt"), shard(cloud.points, mesh, "pt"),
                                 shard(cloud.valid, mesh, "pt"))]
    sums = []
    for parts in zip(*shards):
        total = parts[0].clone()
        for p in parts[1:]:
            total = total + p
        sums.append(total)
    want = solver._normalize_sums(*sums)
    assert all(torch.equal(x, y)
               for x, y in zip((got.err, got.A, got.g), (want.err, want.A, want.g)))


def test_point_sharded_needs_divisible_points(wireframe):
    """1020 points do not divide over 8 slots: JAX's shard_map and the port
    both refuse (padding with invalid lanes is the caller's job)."""
    struct, cloud = wireframe
    cut = EdgeCloud(cloud.points[:1020], cloud.valid[:1020], cloud.count)
    quad = quad_structure(struct, "dt4")
    R, t = torch.eye(3), torch.zeros(3)
    with pytest.raises(ValueError, match="does not divide"):
        solver.residual_system_point_sharded(quad, cut, CAM, R, t, 30.0, 0.3, True,
                                             cpu_mesh(8, "pt"))
    with pytest.raises(ValueError):
        _jax_point_sharded(quad, cut, R, t, jax_mesh(8, "pt"), "dt4")


# -- candidate verification ---------------------------------------------------


@pytest.fixture(scope="module")
def loop():
    cfg, kfs, _, _ = _loop_keyframes()
    tk = [convert.keyframe_from_numpy(jax.tree.map(np.asarray, k), device="cpu") for k in kfs]
    return cfg, convert.config_from_jax(cfg), kfs, tk


@pytest.mark.parametrize("n_slots", [2, 4])
def test_verify_candidates_sharded(loop, n_slots):
    """Three candidates over 2 slots (padded to 4) and over 4 slots (padded
    with one copy of candidate 0); (0, 2) is rejected at max_error 0.2."""
    cfg, tcfg, kfs, tk = loop
    pairs = [(0, 2), (0, 3), (1, 3)]
    got = lc.verify_candidates_batched(tk, pairs, tcfg, max_error=0.2,
                                       mesh=cpu_mesh(n_slots, "cand"))
    serial = lc.verify_candidates_batched(tk, pairs, tcfg, max_error=0.2)
    assert len(got) == 3 and [v is None for v in got] == [True, False, False]
    for g, s in zip(got, serial):
        assert (g is None) == (s is None)
        if g is not None:
            assert np.array_equal(g[0], s[0]) and g[1] == s[1]
    _same_verdicts(got, jverify(kfs, pairs, cfg, max_error=0.2, mesh=jax_mesh(n_slots, "cand")))
    assert lc.verify_candidates_batched(tk, [], tcfg, mesh=cpu_mesh(n_slots, "cand")) == []


# -- sharded reductions: pose graph and windowed BA ----------------------------


def test_pose_graph_sharded():
    """17 poses, 16 edges: 2 per slot over 8."""
    poses = _random_trajectory(17)
    jedges = jpg.trajectory_to_edges(poses)
    noisy = np.asarray(_perturb(poses))
    edges = convert.edges_from_numpy(jax.tree.map(np.asarray, jedges), device="cpu")
    got = pg.optimize_pose_graph_sharded(torch.from_numpy(noisy), edges, cpu_mesh(8, "edge"),
                                         iters=10)
    want = jpg.optimize_pose_graph_sharded(jnp.asarray(noisy), jedges, jax_mesh(8, "edge"),
                                           axis="edge", iters=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    single = pg.optimize_pose_graph(torch.from_numpy(noisy), edges, iters=10)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0, atol=1e-4)
    assert _jmean_residual(jnp.asarray(got.numpy()), jedges) < 1e-4
    # 15 edges do not divide over 8 slots, in either package.
    cut = pg.PoseGraphEdges(*(x[:15] for x in edges))
    with pytest.raises(ValueError, match="does not divide"):
        pg.optimize_pose_graph_sharded(torch.from_numpy(noisy), cut, cpu_mesh(8, "edge"))
    with pytest.raises(ValueError):
        jpg.optimize_pose_graph_sharded(jnp.asarray(noisy), jpg.PoseGraphEdges(
            *(x[:15] for x in jedges)), jax_mesh(8, "edge"), axis="edge")


def test_window_sharded():
    """5 frames, radius 2: 14 pairs padded to 16 over 8 slots."""
    win, _ = _build_window(n_frames=5, perturb=0.008, seed=5)
    twin = convert.window_from_numpy(jax.tree.map(np.asarray, win), device="cpu")
    opt = OptimizerConfig()
    got = tw.optimize_window_sharded(twin, CAM, opt, cpu_mesh(8, "pair"), iters=6, radius=2)
    want = jw.optimize_window_sharded(win, JCAM, JOpt(), jax_mesh(8, "pair"), iters=6, radius=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    single, _ = tw.optimize_window(twin, *tw.make_pairs(5, radius=2), CAM, opt, iters=6)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0, atol=2e-4)
    assert float(np.abs(got.numpy() - twin.poses.numpy()).max()) > 1e-4  # it moved
