"""K3: the LGSX normal-equation reduction (counterpart of
revo_tpu/ops/pallas/lgsx.py::lgsx_reduce).

From warped points (P, 3), fx/fy-scaled DT gradients (P, 2), residuals
(P,) and weights (P,) (0 on dead lanes) form each point's 6-dof Jacobian row
(optimizer.cpp:216-228) and reduce A = sum w J J^T, g = sum w J r and
s = sum w r^2, unnormalized (the caller divides by the good count).

``lgsx_reduce_ref`` is the plain PyTorch version (the JAX solver's einsum
path, solver.py:264-281).  ``lgsx_reduce`` runs it for a CPU tensor and the
CUDA kernel (revo_tpu_torch/csrc/lgsx.cu) for a tensor on the card;
``lgsx_reduce.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from revo_tpu_torch import kernels


def jacobian(wxp: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """(P, 3) warped points, (P, 2) scaled gradients -> (P, 6) J rows."""
    px, py, pz = wxp[:, 0], wxp[:, 1], wxp[:, 2]
    gx, gy = grads[:, 0], grads[:, 1]
    pz_safe = torch.where(pz == 0, 1e-12, pz)
    iz = 1.0 / pz_safe
    iz2 = iz * iz
    return torch.stack(
        [
            iz * gx,
            iz * gy,
            (-px * iz2) * gx + (-py * iz2) * gy,
            (-px * py * iz2) * gx - (1.0 + py * py * iz2) * gy,
            (1.0 + px * px * iz2) * gx + (px * py * iz2) * gy,
            (-py * iz) * gx + (px * iz) * gy,
        ],
        dim=-1,
    )


def lgsx_reduce_ref(wxp, grads, r, w):
    """Plain K3: (A (6, 6), g (6,), s ()) as float32 einsums."""
    J = jacobian(wxp, grads)
    A = torch.einsum("pi,pj->ij", J * w[:, None], J)
    g = torch.einsum("pi,p->i", J, w * r)
    s = torch.sum(w * r * r)
    return A, g, s


def lgsx_reduce(wxp, grads, r, w):
    """K3 wrapper.  CPU tensors: plain version; CUDA tensors: the kernel."""
    if wxp.device.type == "cpu":
        return lgsx_reduce_ref(wxp, grads, r, w)
    if wxp.device.type != "cuda":
        raise ValueError(f"lgsx_reduce: unsupported device {wxp.device}")
    p = wxp.shape[0]
    shapes = ((wxp, (p, 3)), (grads, (p, 2)), (r, (p,)), (w, (p,)))
    for x, shape in shapes:
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(
                f"lgsx_reduce: want float32 {shape}, got {x.dtype} {tuple(x.shape)}"
            )
    wxp, grads, r, w = (x.contiguous() for x, _ in shapes)
    out = torch.empty(43, dtype=torch.float32, device=wxp.device)
    kernels.launch("revo_lgsx_reduce", wxp, grads, r, w, out, p)
    lgsx_reduce.launches += 1
    return out[:36].view(6, 6), out[36:42], out[42]


lgsx_reduce.launches = 0
