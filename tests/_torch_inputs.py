"""Seeded inputs of the residual pass for the port's tests: a keyframe table
(dt quad, 12-component quad or structure rows), an edge cloud
back-projected from integer pixels, and a pose, at 160x120 unless a camera
is given.  Imports no jax, so the tests that run where the
card is can use it.
"""
import numpy as np
import torch

from revo_tpu_torch import lie
from revo_tpu_torch.config import CameraConfig
from revo_tpu_torch.ops.backproject import EdgeCloud

CAM = dict(fx=150.0, fy=152.5, cx=79.5, cy=60.25, width=160, height=120)
EDGE_DISTANCE, HUBER = 6.0, 0.3


# The table forms the residual pass reads (ops.lgsx.table_layout): the dt
# quad table, the 12-component quad table ("flat"; "flatbf" in bfloat16) and
# the (gx, gy, dt) structure as rows ("take4", a bilinear_impl that is not
# "quad*").
TABLE_FORMS = ("dt4", "dt4bf", "flat", "flatbf", "take4")
BF16_FORMS = ("dt4bf", "flatbf")


def _taps(plane: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H*W, 4C) rows [S(y, x), S(y, x+1), S(y+1, x), S(y+1, x+1)],
    edge-padded (ops.edt.quad_structure)."""
    pad = np.pad(plane, ((0, 1), (0, 1), (0, 0)), mode="edge")
    taps = [pad[:-1, :-1], pad[:-1, 1:], pad[1:, :-1], pad[1:, 1:]]
    return np.concatenate(taps, -1).reshape(-1, 4 * plane.shape[-1])


def make_inputs(seed: int, p: int, quad_form: str, cam=None):
    """(table (H*W, C) float32 holding the values of ``quad_form``'s table,
    points (P, 3), valid (P,)) from a seed; the bfloat16 forms' values are
    rounded to bfloat16.  The structure's gradients are the negated
    central differences of the seeded dt (imgpyramidrgbd.cpp:255-276)."""
    cam = cam or CAM
    rng = np.random.default_rng(seed)
    h, w = cam["height"], cam["width"]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dt = (9.0 * np.abs(np.sin(xx / 9.0 + seed) * np.cos(yy / 7.0))
          + rng.uniform(0, 0.5, (h, w))).astype(np.float32)
    dt[rng.random((h, w)) < 0.02] = 0.0  # on-edge pixels: r == 0 taps
    if quad_form in ("dt4", "dt4bf"):
        quad = _taps(dt[..., None])
    else:
        e = np.pad(dt, 1, mode="edge")
        gx = np.float32(0.5) * (e[1:-1, :-2] - e[1:-1, 2:])
        gy = np.float32(0.5) * (e[:-2, 1:-1] - e[2:, 1:-1])
        struct = np.stack([gx, gy, dt], -1).astype(np.float32)
        quad = struct.reshape(-1, 3) if quad_form == "take4" else _taps(struct)
    if quad_form in BF16_FORMS:
        quad = torch.from_numpy(quad).to(torch.bfloat16).float().numpy()
    # Points over integer pixels of the whole image (borders included), as
    # backproject_edges forms them.
    px = rng.integers(0, w, p).astype(np.float32)
    py = rng.integers(0, h, p).astype(np.float32)
    z = rng.uniform(0.5, 4.0, p).astype(np.float32)
    inv_fx, inv_fy = np.float32(1.0) / np.float32(cam["fx"]), np.float32(1.0) / np.float32(cam["fy"])
    pts = np.stack([z * (px - np.float32(cam["cx"])) * inv_fx,
                    z * (py - np.float32(cam["cy"])) * inv_fy, z], -1).astype(np.float32)
    valid = rng.random(p) < 0.9
    pts[~valid] = 0.0
    return quad, pts, valid


def make_pose(kind: str):
    """"identity", "tracked" (a small motion) or "out" (a motion that throws
    most points out of the image)."""
    if kind == "identity":
        return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    xi = np.array([0.012, -0.007, 0.02, 0.004, -0.009, 0.006], np.float32)
    if kind == "out":
        xi = np.array([0.9, -0.3, 0.1, 0.03, 0.4, -0.08], np.float32)
    R, t = lie.exp_se3(torch.from_numpy(xi))
    return R.numpy(), t.numpy()


def torch_args(quad, pts, valid, R, t, quad_form, device="cpu", cam=None):
    q = torch.from_numpy(quad)
    if quad_form in BF16_FORMS:
        q = q.to(torch.bfloat16)
    cloud = EdgeCloud(
        points=torch.from_numpy(pts).to(device), valid=torch.from_numpy(valid).to(device),
        count=torch.tensor(int(valid.sum()), dtype=torch.int32, device=device))
    return (q.to(device), cloud, CameraConfig(**(cam or CAM)), torch.from_numpy(R).to(device),
            torch.from_numpy(t).to(device), EDGE_DISTANCE, HUBER, True)


def small_config():
    """The port's twin of tests/test_solver.py::small_cfg (160x120, 3
    levels, capacities (4096, 2048, 1024)) for callers that may not import
    jax; tests/test_torch_distributed.py holds it equal to the converted
    JAX config."""
    import dataclasses

    from revo_tpu_torch.config import SystemConfig

    cfg = SystemConfig()
    return dataclasses.replace(
        cfg,
        camera=CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120),
        pyramid=dataclasses.replace(cfg.pyramid, pyr_min_lvl=2, pyr_max_lvl=0,
                                    edge_capacity=(4096, 2048, 1024),
                                    dist_patch_sizes=(20, 10, 5)),
    )
