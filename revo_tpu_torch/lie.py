"""SO(3) / SE(3) maps on torch tensors (counterpart of revo_tpu/lie.py).

The group API of the JAX module: hat/vee, exp/log of SO(3) and SE(3),
compose, inverse, the SE(3) adjoint, Lie brackets, point transforms, geodesic
interpolation and the iterative mean, (R, t) <-> 4x4, the TUM quaternion pair,
and 4x4 products and inverses that round as jitted XLA on the CPU does
(``matmul_fma``, ``inv_lu``).  Same formulas,
small-angle Taylor branches and near-pi log branch as the JAX module, in
float32.  Tangent convention ``xi = [upsilon, omega]`` (Sophus, se3.hpp:723).

The 3x3 products of exp and compose are elementwise (``matmul_fma``,
``matvec``), never a cuBLAS or TF32 ``matmul`` (the JAX side measured
reduced-precision pose products doubling ATE, revo_tpu/lie.py:23-31): they
round on the CPU as PyTorch's 2-D ``matmul`` does there, and each of a stack
of poses rounds as it does alone, on any device, which the solver's lanes
need.  Other products are plain float32 ``matmul``s, which
``chip_smoke.py`` pins off TF32.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.linalg
import torch

from revo_tpu_torch.ops.project import sqrt_rn

_EPS = 1e-8


def _eye_like(x: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(*batch_shape, 3, 3)


def hat_so3(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee_so3(Omega: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat_so3` (so3.hpp ``SO3::vee``)."""
    return torch.stack([Omega[..., 2, 1], Omega[..., 0, 2], Omega[..., 1, 0]], dim=-1)


def _sq_norm3(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over the last axis of (..., 3) vectors as (p0 + p1) + p2 of the
    rounded products p: the order of PyTorch's CPU ``sum`` of three values,
    fixed on the card too (whose reduction kernel adds (p0 + p2) + p1), so
    the solver's step kernel can repeat it (csrc/solver.cu)."""
    p = v * v
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula with Taylor fallback (so3.hpp ``SO3::exp``)."""
    theta_sq = _sq_norm3(omega)
    theta = sqrt_rn(theta_sq)
    small = theta_sq < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta_safe)) / (theta_safe * theta_safe),
    )
    W = hat_so3(omega)
    W2 = matmul_fma(W, W)
    eye = _eye_like(omega, W.shape[:-2])
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation-matrix logarithm, stable near 0 (Taylor) and near pi (axis
    from the diagonal of (R + I) / 2)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = 0.5 * torch.linalg.vector_norm(skew, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    theta_sq = theta * theta
    near_zero = theta_sq < _EPS
    near_pi = (math.pi - theta) < 1e-3

    sin_safe = torch.where(sin_theta == 0, torch.ones_like(sin_theta), sin_theta)
    factor = torch.where(
        near_zero, 0.5 + theta_sq / 12.0, theta / (2.0 * sin_safe)
    )
    omega_generic = factor[..., None] * skew

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    RI = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    col = torch.gather(
        RI, -1, k[..., None, None].expand(*k.shape, 3, 1)
    )[..., 0]
    col_norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    col_safe = col / torch.where(col_norm == 0, torch.ones_like(col_norm), col_norm)
    sign = torch.where(
        torch.sum(col_safe * skew, dim=-1, keepdim=True) < 0, -1.0, 1.0
    )
    omega_pi = theta[..., None] * col_safe * sign
    return torch.where(near_pi[..., None], omega_pi, omega_generic)


def _so3_left_jacobian_terms(omega: torch.Tensor):
    """Coefficients (b, c) of V = I + b W + c W^2 (se3.hpp:741-766)."""
    theta_sq = _sq_norm3(omega)
    theta = sqrt_rn(theta_sq)
    small = theta_sq < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    b = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta_safe)) / (theta_safe * theta_safe),
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta_safe - torch.sin(theta_safe))
        / (theta_safe * theta_safe * theta_safe),
    )
    return b, c


def exp_se3(xi: torch.Tensor):
    """SE(3) exponential: xi = [upsilon, omega] -> (R, t = V upsilon)."""
    upsilon = xi[..., :3]
    omega = xi[..., 3:]
    R = exp_so3(omega)
    b, c = _so3_left_jacobian_terms(omega)
    W = hat_so3(omega)
    W2 = matmul_fma(W, W)
    eye = _eye_like(xi, W.shape[:-2])
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, matvec(V, upsilon)


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm (se3.hpp ``SE3::log``)."""
    omega = log_so3(R)
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta_sq), sqrt_rn(theta_sq))
    half = theta_safe * 0.5
    e = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / theta_sq,
    )
    W = hat_so3(omega)
    W2 = W @ W
    eye = _eye_like(R, W.shape[:-2])
    Vinv = eye - 0.5 * W + e[..., None, None] * W2
    upsilon = (Vinv @ t[..., None])[..., 0]
    return torch.cat([upsilon, omega], dim=-1)


def compose(R1, t1, R2, t2):
    """(R1, t1) * (R2, t2): first apply 2, then 1."""
    return matmul_fma(R1, R2), matvec(R1, t2) + t1


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform_points(R, t, pts):
    """Apply (R, t) to points of shape (..., N, 3).  Multiply and sum, never
    a float32 ``matmul``: N can be a whole cloud, and the card must not
    round it to TF32."""
    return (R[..., None, :, :] * pts[..., None, :]).sum(-1) + t[..., None, :]


def adjoint_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint Ad(T) of (R, t) on tangent vectors (se3.hpp ``Adj``;
    revo_tpu/lie.py::adjoint_se3).  With xi = [upsilon, omega]:
    Ad = [[R, hat(t) R], [0, R]]."""
    top = torch.cat([R, hat_so3(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def hat_se3(xi: torch.Tensor) -> torch.Tensor:
    """4x4 matrix form of a twist (se3.hpp ``SE3::hat``).  With
    xi = [upsilon, omega]: [[hat(omega), upsilon], [0, 0]]."""
    top = torch.cat([hat_so3(xi[..., 3:]), xi[..., :3, None]], dim=-1)
    bottom = torch.zeros(*top.shape[:-2], 1, 4, dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def vee_se3(X: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat_se3` (se3.hpp ``SE3::vee``)."""
    return torch.cat([X[..., :3, 3], vee_so3(X[..., :3, :3])], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b on the last axis.  Each component x * y - z * w rounds as
    ``jnp.cross`` does on the CPU, where XLA contracts it into one fused
    multiply-add onto the rounded second product; the fused step is taken in
    the next wider type (the product of two float32 values is exact in
    float64), so the result is the same on every device."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    wide = torch.float64 if a.dtype == torch.float32 else a.dtype

    def diff(x, y, z, w):
        return (x.to(wide) * y.to(wide) - (z * w).to(wide)).to(a.dtype)

    return torch.stack(
        [diff(a1, b2, a2, b1), diff(a2, b0, a0, b2), diff(a0, b1, a1, b0)], dim=-1
    )


def lie_bracket_so3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """so(3) Lie bracket [a, b] = a x b (so3.hpp ``SO3::lieBracket``)."""
    return _cross(a, b)


def lie_bracket_se3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """se(3) Lie bracket (se3.hpp ``SE3::lieBracket``):
    [a, b] = [omega_a x ups_b + ups_a x omega_b, omega_a x omega_b], which
    equals vee(hat(a) hat(b) - hat(b) hat(a))."""
    ups_a, om_a = a[..., :3], a[..., 3:]
    ups_b, om_b = b[..., :3], b[..., 3:]
    return torch.cat(
        [_cross(om_a, ups_b) + _cross(ups_a, om_b), _cross(om_a, om_b)], dim=-1
    )


def interpolate_se3(Ra, ta, Rb, tb, alpha):
    """Geodesic interpolation a * exp(alpha * log(a^-1 * b))
    (sophus/interpolate.hpp:28-38).  ``alpha`` may be batched."""
    Ri, ti = inverse(Ra, ta)
    xi = log_se3(*compose(Ri, ti, Rb, tb))
    alpha = torch.as_tensor(alpha, dtype=xi.dtype, device=xi.device)
    dR, dt = exp_se3(alpha[..., None] * xi)
    return compose(Ra, ta, dR, dt)


def average_se3(R: torch.Tensor, t: torch.Tensor, iters: int = 20):
    """Iterative bi-invariant mean of a set of poses (sophus/average.hpp
    ``iterativeMean``): X <- X * exp(mean_i log(X^-1 * T_i)), a fixed
    iteration count like the JAX module's (Sophus runs at most 20).

    R: (N, 3, 3), t: (N, 3).  Returns (R_mean, t_mean)."""
    Rm, tm = R[0], t[0]
    for _ in range(iters):
        Ri, ti = inverse(Rm, tm)
        xi = log_se3(*compose(Ri[None], ti[None], R, t)).mean(dim=0)
        dR, dt = exp_se3(xi)
        Rm, tm = compose(Rm, tm, dR, dt)
    return Rm, tm


def matrix_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix from (R, t)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(*batch, 4, 4, dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rt_from_matrix(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def matmul_fma(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """float32 ``A @ B`` for small matrices, rounded as XLA's CPU dot rounds
    it inside ``jit``: each entry is the first product, then one fused
    multiply-add per further term in order.  Each FMA is taken in float64
    (the product of two float32 values is exact there, so ``addcmul``'s
    one rounding is the FMA's), so the result is the same on every device
    and never passes through cuBLAS or TF32."""
    Ad, Bd = A.double(), B.double()
    acc = (Ad[..., :, 0:1] * Bd[..., 0:1, :]).float()
    for k in range(1, A.shape[-1]):
        acc = torch.addcmul(acc.double(), Ad[..., :, k:k + 1], Bd[..., k:k + 1, :]).float()
    return acc


def matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` for (..., 3, 3) matrices and (..., 3) vectors as
    elementwise float32 ops: the three products summed last to first, each
    operation rounded, as PyTorch's CPU (3, 3) @ (3, 1) product rounds.
    Lanes stacked on the leading axes get the bits each gets alone, on any
    device (a batched ``matmul`` may take another kernel per batch size)."""
    return (A[..., 2] * v[..., None, 2] + A[..., 1] * v[..., None, 1]) + A[..., 0] * v[..., None, 0]


def inv_lu(T: torch.Tensor) -> torch.Tensor:
    """float32 inverse of small square matrices (..., n, n) by LU with
    partial pivoting and two triangular solves (LAPACK getrf + getrs through
    scipy), on the host: the algorithm and rounding of ``jnp.linalg.inv`` on
    the CPU.  Returns a tensor on ``T``'s device."""
    a = T.detach().cpu().numpy().astype(np.float32)
    eye = np.eye(a.shape[-1], dtype=np.float32)
    flat = a.reshape(-1, *a.shape[-2:])
    inv = np.stack([
        scipy.linalg.lu_solve(scipy.linalg.lu_factor(m), eye) for m in flat
    ]).reshape(a.shape)
    return torch.from_numpy(inv.astype(np.float32)).to(T.device)


def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM pose-file order, by
    the largest of the four Shepperd candidates; canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1)
    qx0 = torch.stack(
        [1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1
    )
    qy0 = torch.stack(
        [m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1
    )
    qz0 = torch.stack(
        [m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1
    )
    cands = torch.stack([qw0, qx0, qy0, qz0], dim=-2)  # (..., 4, 4)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)
    q = torch.gather(
        cands, -2, best[..., None, None].expand(*best.shape, 1, 4)
    )[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n == 0, torch.zeros_like(n), 2.0 / n)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
