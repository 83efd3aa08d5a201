"""revo_tpu_torch.lie against revo_tpu.lie on the same seeded inputs.

float32 on both sides; the tolerance is a few float32 ulps of the unit-scale
outputs (1e-6 absolute), looser (1e-5) where log near pi amplifies rounding
of the input matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revo_tpu import lie as jl
from revo_tpu_torch import lie as tl

torch.set_num_threads(1)


def _xi(seed, n=64, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.3, 1.5])
def test_exp_se3_matches_jax(scale):
    xi = _xi(1, scale=scale)
    Rj, tj = jl.exp_se3(jnp.asarray(xi))
    Rt, tt = tl.exp_se3(torch.from_numpy(xi))
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), _np(tj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.3, 1.5])
def test_log_se3_matches_jax_and_round_trips(scale):
    xi = _xi(2, scale=scale)
    R, t = tl.exp_se3(torch.from_numpy(xi))
    got = tl.log_se3(R, t).numpy()
    want = _np(jl.log_se3(jnp.asarray(R.numpy()), jnp.asarray(t.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Round trip exp(log(T)) = T (xi itself only below pi).
    R2, t2 = tl.exp_se3(torch.from_numpy(got))
    np.testing.assert_allclose(R2.numpy(), R.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), t.numpy(), rtol=1e-4, atol=1e-5)
    below_pi = np.linalg.norm(xi[:, 3:], axis=1) < 3.0
    np.testing.assert_allclose(got[below_pi], xi[below_pi], rtol=1e-4, atol=1e-5)


def test_exp_so3_small_angle_branch():
    om = np.array([[0.0, 0.0, 0.0], [1e-5, -2e-5, 3e-5]], np.float32)
    got = tl.exp_so3(torch.from_numpy(om)).numpy()
    want = _np(jl.exp_so3(jnp.asarray(om)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))


@pytest.mark.parametrize("eps", [0.0, 1e-5, 5e-4])
def test_log_so3_near_pi(eps):
    rng = np.random.default_rng(3)
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    om = (axes * (np.pi - eps)).astype(np.float32)
    R = tl.exp_so3(torch.from_numpy(om))
    got = tl.log_so3(R).numpy()
    want = _np(jl.log_so3(jnp.asarray(R.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # Round trip through exp (the axis sign is ambiguous at exactly pi); the
    # near-pi branch reads the axis off diag((R + I) / 2), exact only at pi,
    # so its error grows with the distance eps from pi.
    R2 = tl.exp_so3(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(R2, R.numpy(), rtol=0, atol=1e-5 + eps)


def test_compose_inverse_matrix_round_trip():
    xa, xb = _xi(4, n=8, scale=0.5), _xi(5, n=8, scale=0.5)
    Ra, ta = tl.exp_se3(torch.from_numpy(xa))
    Rb, tb = tl.exp_se3(torch.from_numpy(xb))
    Rc, tc = tl.compose(Ra, ta, Rb, tb)
    Rj, tj = jl.compose(*(jnp.asarray(x.numpy()) for x in (Ra, ta, Rb, tb)))
    np.testing.assert_allclose(Rc.numpy(), _np(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), _np(tj), rtol=0, atol=1e-6)
    Ri, ti = tl.inverse(Ra, ta)
    Re, te = tl.compose(Ri, ti, Ra, ta)
    np.testing.assert_allclose(Re.numpy(), np.broadcast_to(np.eye(3), Re.shape), atol=1e-6)
    np.testing.assert_allclose(te.numpy(), 0.0, atol=1e-6)
    T = tl.matrix_from_rt(Ra, ta)
    np.testing.assert_array_equal(T.numpy(), _np(jl.matrix_from_rt(
        jnp.asarray(Ra.numpy()), jnp.asarray(ta.numpy()))))
    R2, t2 = tl.rt_from_matrix(T)
    np.testing.assert_array_equal(R2.numpy(), Ra.numpy())
    np.testing.assert_array_equal(t2.numpy(), ta.numpy())


@pytest.mark.parametrize("scale", [1e-4, 0.5, 3.0])
def test_quaternion_pair_matches_jax(scale):
    xi = _xi(6, scale=scale)
    R, _ = tl.exp_se3(torch.from_numpy(xi))
    q = tl.quaternion_from_matrix(R)
    np.testing.assert_allclose(
        q.numpy(), _np(jl.quaternion_from_matrix(jnp.asarray(R.numpy()))),
        rtol=0, atol=1e-6,
    )
    assert (q[:, 3] >= 0).all()
    np.testing.assert_allclose(
        tl.matrix_from_quaternion(q).numpy(), R.numpy(), rtol=0, atol=1e-5
    )
