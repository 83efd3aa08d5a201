"""The port's SE(3) adjoint and pose-graph optimizer against the JAX
package's (revo_tpu.lie.adjoint_se3, revo_tpu.parallel.posegraph), on the
same seeded numpy inputs, on the CPU; the cases of tests/test_posegraph.py.

Tolerances: adjoint within 1e-6 (one 3x3 product); residuals within 1e-5
(two 4x4 inverses by different LU codes, then a log); one assembled system
within 1e-4 relative of its largest entry; optimized poses within 1e-4 after
10-20 GN iterations (each solves a dense float32 system by another LU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import lie as jlie
from revo_tpu.parallel import posegraph as jpg
from revo_tpu_torch import convert, lie
from revo_tpu_torch.parallel import posegraph as pg

torch.set_num_threads(1)

POSE_TOL = 1e-4


def _exp(xi):
    return lie.matrix_from_rt(*lie.exp_se3(torch.from_numpy(xi))).numpy()


def _random_trajectory(n, seed=0, step=0.1):
    xs = np.random.default_rng(seed).normal(size=(n - 1, 6)).astype(np.float32) * step
    poses = [np.eye(4, dtype=np.float32)]
    for xi in xs:
        poses.append(poses[-1] @ _exp(xi))
    return np.stack(poses)


def _perturb(poses, seed=1, scale=0.05):
    xi = np.random.default_rng(seed).normal(size=(poses.shape[0], 6)).astype(np.float32) * scale
    xi[0] = 0.0  # keep the gauge node exact
    return _exp(xi) @ poses


def _edges_np(poses):
    n = poses.shape[0]
    i = np.arange(n - 1, dtype=np.int32)
    return dict(i=i, j=i + 1, T_meas=np.linalg.inv(poses[:-1]) @ poses[1:],
                weight=np.ones(n - 1, np.float32))


def _concat(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _both(e):
    """The same edge arrays as a JAX and a port PoseGraphEdges."""
    return (jpg.PoseGraphEdges(**{k: jnp.asarray(v) for k, v in e.items()}),
            convert.edges_from_numpy(e, device="cpu"))


def _mean_residual(poses, edges):
    r = pg.pose_graph_residuals(poses, edges)
    return float(r[edges.weight > 0].square().sum(-1).sqrt().mean())


def test_adjoint_matches_jax():
    xi = np.random.default_rng(3).normal(size=(7, 6)).astype(np.float32)
    R, t = lie.exp_se3(torch.from_numpy(xi))
    want = np.asarray(jlie.adjoint_se3(jnp.asarray(R.numpy()), jnp.asarray(t.numpy())))
    got = lie.adjoint_se3(R, t).numpy()
    assert got.shape == (7, 6, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Ad(T) maps a twist through conjugation: T exp(xi) T^-1 = exp(Ad xi).
    small = torch.tensor([1e-3, -2e-3, 5e-4, 1e-3, 2e-3, -1e-3])
    T = lie.matrix_from_rt(R[0], t[0])
    lhs = T @ lie.matrix_from_rt(*lie.exp_se3(small)) @ torch.linalg.inv(T)
    rhs = lie.matrix_from_rt(*lie.exp_se3(lie.adjoint_se3(R[0], t[0]) @ small))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-6)


def test_residuals_and_system_match_jax():
    poses = _random_trajectory(10)
    noisy = _perturb(poses)
    ej, et = _both(_edges_np(poses))
    r0 = pg.pose_graph_residuals(torch.from_numpy(poses), et)
    assert float(r0.abs().max()) < 1e-5  # consistent graph: zero residuals
    rj = np.asarray(jpg.pose_graph_residuals(jnp.asarray(noisy), ej))
    rt = pg.pose_graph_residuals(torch.from_numpy(noisy), et).numpy()
    assert np.abs(rj).max() > 0.01
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-5)
    Hj, bj = jpg._assemble(jnp.asarray(noisy), ej, 10)
    Ht, bt = pg._assemble(torch.from_numpy(noisy), et, 10)
    for a, b in ((Ht, Hj), (bt, bj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_recovers_perturbed_chain_like_jax():
    poses = _random_trajectory(15)
    noisy = _perturb(poses)
    ej, et = _both(_edges_np(poses))
    assert _mean_residual(torch.from_numpy(noisy), et) > 0.01
    refined = pg.optimize_pose_graph(torch.from_numpy(noisy), et, iters=15)
    assert _mean_residual(refined, et) < 1e-4
    np.testing.assert_allclose(refined[0].numpy(), poses[0], atol=1e-5)  # gauge
    want = np.asarray(jpg.optimize_pose_graph(jnp.asarray(noisy), ej, iters=15))
    np.testing.assert_allclose(refined.numpy(), want, rtol=0, atol=POSE_TOL)


def test_loop_closure_distributes_error_like_jax():
    """Chain + a loop edge carrying the true relative pose: the end node is
    pulled to consistency with it."""
    poses = _random_trajectory(12, step=0.15)
    loop = dict(i=np.array([0], np.int32), j=np.array([11], np.int32),
                T_meas=(np.linalg.inv(poses[0]) @ poses[11])[None],
                weight=np.array([5.0], np.float32))
    ej, et = _both(_concat(_edges_np(poses), loop))
    noisy = _perturb(poses, scale=0.08)
    refined = pg.optimize_pose_graph(torch.from_numpy(noisy), et, iters=20)
    r = pg.pose_graph_residuals(refined, convert.edges_from_numpy(loop, device="cpu"))
    assert float(torch.linalg.vector_norm(r)) < 1e-3
    want = np.asarray(jpg.optimize_pose_graph(jnp.asarray(noisy), ej, iters=20))
    np.testing.assert_allclose(refined.numpy(), want, rtol=0, atol=POSE_TOL)


def test_padding_edges_ignored():
    poses = _random_trajectory(8)
    e = _edges_np(poses)
    pad = dict(i=np.zeros(5, np.int32), j=np.zeros(5, np.int32),
               T_meas=np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)),
               weight=np.zeros(5, np.float32))
    noisy = torch.from_numpy(_perturb(poses))
    a = pg.optimize_pose_graph(noisy, convert.edges_from_numpy(e, device="cpu"), iters=10)
    b = pg.optimize_pose_graph(noisy, convert.edges_from_numpy(_concat(e, pad), device="cpu"),
                               iters=10)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_trajectory_to_edges_and_sharded_form():
    poses = _random_trajectory(6)
    got = pg.trajectory_to_edges(torch.from_numpy(poses))
    want = jpg.trajectory_to_edges(jnp.asarray(poses))
    np.testing.assert_array_equal(got.i.numpy(), np.asarray(want.i))
    np.testing.assert_array_equal(got.j.numpy(), np.asarray(want.j))
    np.testing.assert_allclose(got.T_meas.numpy(), np.asarray(want.T_meas), atol=1e-6)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    with pytest.raises(TypeError, match="Mesh"):
        pg.optimize_pose_graph_sharded(torch.from_numpy(poses), got, mesh=object())
