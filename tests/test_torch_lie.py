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


# -- the rest of the group API (tests/test_lie.py:69-303 against JAX) ------------


def test_hat_vee_bit_equal():
    """hat / vee move entries and never round: equal to JAX bit for bit, and
    vee(hat(x)) == x (tests.hpp veeHatTest)."""
    xi = _xi(7, scale=0.8)
    om = xi[:, 3:]
    np.testing.assert_array_equal(tl.hat_so3(torch.from_numpy(om)).numpy(),
                                  _np(jl.hat_so3(jnp.asarray(om))))
    np.testing.assert_array_equal(tl.hat_se3(torch.from_numpy(xi)).numpy(),
                                  _np(jl.hat_se3(jnp.asarray(xi))))
    X = np.random.default_rng(8).normal(size=(5, 7, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(tl.vee_so3(torch.from_numpy(X[..., :3, :3])).numpy(),
                                  _np(jl.vee_so3(jnp.asarray(X[..., :3, :3]))))
    np.testing.assert_array_equal(tl.vee_se3(torch.from_numpy(X)).numpy(),
                                  _np(jl.vee_se3(jnp.asarray(X))))
    np.testing.assert_array_equal(tl.vee_so3(tl.hat_so3(torch.from_numpy(om))).numpy(), om)
    np.testing.assert_array_equal(tl.vee_se3(tl.hat_se3(torch.from_numpy(xi))).numpy(), xi)
    assert tl.hat_se3(torch.from_numpy(xi[0])).shape == (4, 4)


@pytest.mark.parametrize("shape", [(6,), (9, 6), (3, 4, 6)])
def test_lie_brackets_bit_equal(shape):
    """Each bracket component is one difference of two products (a sum of
    two for the se(3) translation part), rounded as jnp.cross rounds it on
    the CPU (one fused multiply-add): equal to JAX bit for bit; and [a, b] = vee(hat(a) hat(b) - hat(b) hat(a)) (tests.hpp
    lieBracketTest) within 1e-5."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tl.lie_bracket_se3(ta, tb)
    np.testing.assert_array_equal(got.numpy(), _np(jl.lie_bracket_se3(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        tl.lie_bracket_so3(ta[..., 3:], tb[..., 3:]).numpy(),
        _np(jl.lie_bracket_so3(jnp.asarray(a[..., 3:]), jnp.asarray(b[..., 3:]))))
    ha, hb = tl.hat_se3(ta), tl.hat_se3(tb)
    np.testing.assert_allclose(got.numpy(), tl.vee_se3(ha @ hb - hb @ ha).numpy(), atol=1e-5)
    np.testing.assert_allclose(tl.lie_bracket_se3(tb, ta).numpy(), -got.numpy(), atol=1e-6)


def test_lie_bracket_jacobi_and_adjoint_differential():
    a, b, c = (torch.from_numpy(x) for x in _xi(10, n=3))
    jacobi = (tl.lie_bracket_se3(a, tl.lie_bracket_se3(b, c))
              + tl.lie_bracket_se3(b, tl.lie_bracket_se3(c, a))
              + tl.lie_bracket_se3(c, tl.lie_bracket_se3(a, b)))
    np.testing.assert_allclose(jacobi.numpy(), 0.0, atol=1e-5)
    # d/ds Ad(exp(s a)) b at 0 is [a, b] (finite difference, test_lie.py:203-216).
    a, b, eps = 0.5 * a, 0.5 * b, 1e-3
    fd = (tl.adjoint_se3(*tl.exp_se3(eps * a)) @ b
          - tl.adjoint_se3(*tl.exp_se3(-eps * a)) @ b) / (2 * eps)
    np.testing.assert_allclose(fd.numpy(), tl.lie_bracket_se3(a, b).numpy(), atol=5e-3)


@pytest.mark.parametrize("batch", [(), (7,), (2, 3)])
def test_transform_points_matches_jax(batch):
    """tests.hpp groupActionTest: T(p) == matrix @ p, against JAX's
    highest-precision einsum to 1e-6 on unit-scale points."""
    rng = np.random.default_rng(11)
    xi = (rng.normal(size=batch + (6,)) * 0.5).astype(np.float32)
    pts = rng.normal(size=batch + (5, 3)).astype(np.float32)
    R, t = tl.exp_se3(torch.from_numpy(xi))
    got = tl.transform_points(R, t, torch.from_numpy(pts)).numpy()
    want = _np(jl.transform_points(jnp.asarray(R.numpy()), jnp.asarray(t.numpy()), jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    T = tl.matrix_from_rt(R, t).numpy().astype(np.float64)
    ph = np.concatenate([pts, np.ones(batch + (5, 1), np.float32)], axis=-1)
    np.testing.assert_allclose(got, np.einsum("...ij,...pj->...pi", T, ph)[..., :3], atol=1e-5)


@pytest.mark.parametrize("alpha", [0.0, 0.25, 0.5, 1.0, [0.1, 0.6, 0.9]])
def test_interpolate_se3_matches_jax(alpha):
    xa, xb = _xi(12, n=3, scale=0.4), _xi(13, n=3, scale=0.4)
    if not isinstance(alpha, list):
        xa, xb = xa[0], xb[0]
    Ra, ta = tl.exp_se3(torch.from_numpy(xa))
    Rb, tb = tl.exp_se3(torch.from_numpy(xb))
    Rg, tg = tl.interpolate_se3(Ra, ta, Rb, tb, alpha)
    Rj, tj = jl.interpolate_se3(*(jnp.asarray(x.numpy()) for x in (Ra, ta, Rb, tb)),
                                jnp.asarray(alpha, jnp.float32))
    np.testing.assert_allclose(Rg.numpy(), _np(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), _np(tj), rtol=0, atol=1e-6)
    # Geodesic: log(a^-1 interp) == alpha log(a^-1 b); endpoints at 0 and 1.
    Ri, ti = tl.inverse(Ra, ta)
    full = tl.log_se3(*tl.compose(Ri, ti, Rb, tb))
    part = tl.log_se3(*tl.compose(Ri, ti, Rg, tg))
    a = torch.as_tensor(alpha, dtype=torch.float32)
    np.testing.assert_allclose(part.numpy(), (a[..., None] * full).numpy(), atol=1e-5)


def test_interpolate_left_equivariance():
    """interp(g a, g b, alpha) == g interp(a, b, alpha)."""
    g, a, b = (tl.exp_se3(torch.from_numpy(x)) for x in _xi(14, n=3, scale=0.5))
    lhs = tl.interpolate_se3(*tl.compose(*g, *a), *tl.compose(*g, *b), 0.3)
    rhs = tl.compose(*g, *tl.interpolate_se3(*a, *b, 0.3))
    np.testing.assert_allclose(lhs[0].numpy(), rhs[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(lhs[1].numpy(), rhs[1].numpy(), atol=1e-5)


@pytest.mark.parametrize("iters", [1, 20])
def test_average_se3_matches_jax(iters):
    """The iterative mean against JAX's 20-trip fori_loop, and its defining
    property sum_i log(M^-1 T_i) == 0 (average.hpp)."""
    rng = np.random.default_rng(15)
    base = tl.exp_se3(torch.from_numpy(_xi(16, n=1, scale=0.6)[0]))
    dR, dt = tl.exp_se3(torch.from_numpy(rng.normal(scale=0.1, size=(12, 6)).astype(np.float32)))
    R, t = tl.compose(base[0][None], base[1][None], dR, dt)
    Rm, tm = tl.average_se3(R, t, iters)
    Rj, tj = jl.average_se3(jnp.asarray(R.numpy()), jnp.asarray(t.numpy()), iters)
    np.testing.assert_allclose(Rm.numpy(), _np(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), _np(tj), rtol=0, atol=1e-6)
    if iters == 20:
        Ri, ti = tl.inverse(Rm, tm)
        logs = tl.log_se3(*tl.compose(Ri[None], ti[None], R, t))
        np.testing.assert_allclose(logs.mean(dim=0).numpy(), 0.0, atol=1e-5)
        same = tl.average_se3(base[0].expand(5, 3, 3), base[1].expand(5, 3))
        np.testing.assert_allclose(same[0].numpy(), base[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(same[1].numpy(), base[1].numpy(), atol=1e-6)
