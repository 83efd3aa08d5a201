"""Pose-graph Gauss-Newton optimization, on one device or with the edges
sharded over a mesh (counterpart of revo_tpu/parallel/posegraph.py).

Nodes are world poses T_i (world-from-node); an edge (i, j) carries a
measured relative pose M_ij ~ T_i^-1 T_j.  Minimized over left-multiplicative
updates T_i <- exp(xi_i) T_i, node 0 fixed (gauge):

    sum_e w_e || log( M_e^-1  T_i(e)^-1 T_j(e) ) ||^2

With E_e = M^-1 Ti^-1 Tj and J_r^-1(log E) ~ I the edge Jacobians are
d r / d xi_j = +Ad(T_j^-1) and d r / d xi_i = -Ad(T_j^-1).  The normal
equations are dense (6N, 6N): keyframe graphs have tens to hundreds of
nodes.  ``optimize_pose_graph`` stays on the device of ``poses``.

The block scatters are ``index_put_(accumulate=True)``.  On the card that
is atomic adds, so where several edges meet in one block the order of their
sum is not fixed: results agree with the CPU's, and from run to run, to
float32 rounding of the sums, not bit for bit.  The dense solve is
``torch.linalg.solve`` (JAX leaves it to XLA's LU, outside any kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from revo_tpu_torch import lie
from revo_tpu_torch.parallel.mesh import local_slots, psum, replicate, shard


class PoseGraphEdges(NamedTuple):
    """Fixed-shape edge list; weight 0 marks a padding lane."""

    i: torch.Tensor  # (E,) integer source node
    j: torch.Tensor  # (E,) integer target node
    T_meas: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    weight: torch.Tensor  # (E,) float32 information weight (0 for padding)


def pose_graph_residuals(poses: torch.Tensor, edges: PoseGraphEdges) -> torch.Tensor:
    """Per-edge 6-vector residuals log(M^-1 Ti^-1 Tj); (E, 6)."""
    Ti = poses[edges.i.long()]
    Tj = poses[edges.j.long()]
    E = torch.linalg.inv(edges.T_meas) @ torch.linalg.inv(Ti) @ Tj
    return lie.log_se3(E[..., :3, :3], E[..., :3, 3])


def _assemble(poses: torch.Tensor, edges: PoseGraphEdges, n: int):
    """Block (n, n, 6, 6) H and (n, 6) b from the edge set (one GN step)."""
    r = pose_graph_residuals(poses, edges)  # (E, 6)
    i, j = edges.i.long(), edges.j.long()
    Tj_inv = torch.linalg.inv(poses[j])
    Ad = lie.adjoint_se3(Tj_inv[..., :3, :3], Tj_inv[..., :3, 3])  # (E, 6, 6)

    # Block contributions: Jj = +Ad, Ji = -Ad.
    AtA = torch.einsum("eki,ekj->eij", Ad, Ad) * edges.weight[:, None, None]
    Atr = torch.einsum("eki,ek->ei", Ad, r) * edges.weight[:, None]

    H = torch.zeros((n, n, 6, 6), dtype=poses.dtype, device=poses.device)
    b = torch.zeros((n, 6), dtype=poses.dtype, device=poses.device)
    H.index_put_((j, j), AtA, accumulate=True)
    H.index_put_((i, i), AtA, accumulate=True)
    H.index_put_((i, j), -AtA, accumulate=True)
    H.index_put_((j, i), -AtA, accumulate=True)
    b.index_put_((j,), -Atr, accumulate=True)
    b.index_put_((i,), Atr, accumulate=True)
    return H, b


def _solve_and_update(poses, H, b, n: int, damping: float):
    """Fix node 0 (gauge), solve the damped system, retract."""
    Hd = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    bd = b.reshape(6 * n)
    # Gauge: node 0's rows and columns are zeroed and get an identity
    # diagonal (so xi_0 = 0 exactly); free rows get light Tikhonov damping.
    mask = torch.ones(6 * n, dtype=poses.dtype, device=poses.device)
    mask[:6] = 0.0
    Hd = Hd * mask[:, None] * mask[None, :]
    Hd = Hd + torch.diag(torch.where(mask > 0, damping, 1.0).to(poses.dtype))
    bd = bd * mask
    xi = torch.linalg.solve(Hd, bd).reshape(n, 6)
    dR, dt = lie.exp_se3(xi)
    return lie.matrix_from_rt(dR, dt) @ poses


def optimize_pose_graph(
    poses: torch.Tensor, edges: PoseGraphEdges, iters: int = 10, damping: float = 1e-6
) -> torch.Tensor:
    """GN pose-graph optimization; returns refined (N, 4, 4) poses on the
    device of ``poses``."""
    n = poses.shape[0]
    for _ in range(iters):
        H, b = _assemble(poses, edges, n)
        poses = _solve_and_update(poses, H, b, n, damping)
    return poses


def optimize_pose_graph_sharded(poses: torch.Tensor, edges: PoseGraphEdges, mesh,
                                axis: str = "edge", iters: int = 10,
                                damping: float = 1e-6) -> torch.Tensor:
    """Distributed GN: the edges are sharded over ``axis`` of ``mesh`` (E
    must divide by its size; pad with weight-0 lanes), each slot assembles
    the block normal equations of its share, ``psum`` meets them, and the
    solve runs once on the first slot's device (on every rank under a
    process group), whose poses the next iteration replicates.  Returns
    the refined (N, 4, 4) poses there."""
    n = poses.shape[0]
    local = shard(edges, mesh, axis)
    poses = poses.to(local_slots(mesh, axis)[0])
    for _ in range(iters):
        Hs, bs = zip(*(_assemble(P, e, n) for P, e in zip(replicate(poses, mesh, axis), local)))
        poses = _solve_and_update(poses, psum(Hs, mesh, axis), psum(bs, mesh, axis), n, damping)
    return poses


def trajectory_to_edges(poses: torch.Tensor) -> PoseGraphEdges:
    """Consecutive-frame odometry edges from a trajectory (testing helper)."""
    n = poses.shape[0]
    i = torch.arange(n - 1, dtype=torch.int32, device=poses.device)
    return PoseGraphEdges(
        i=i, j=i + 1, T_meas=torch.linalg.inv(poses[:-1]) @ poses[1:],
        weight=torch.ones(n - 1, dtype=torch.float32, device=poses.device),
    )
